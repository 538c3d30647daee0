"""fontrx_torch.bound counts the root-solve work these inputs need: by hand on
a square and a parabola, and against a scalar loop over the float program
on glyphs of DejaVu Sans. For the SDF it counts the (segment, pixel) pairs
the function needs, fewer than the JAX package's per-tile lists
(``pack_sdf_tiles``) hold, and the least operations of the distance
program, held to a scalar loop that counts each operation as it runs and
gives the plain version's distances."""

import operator
import pathlib

import numpy as np
import pytest

import torch

from fontrx_torch.bench.cjk import UPEM, synthetic_strokes
from fontrx_torch.bound import (
    FP32_OPS_PER_S, HBM_BYTES_PER_S, PAGE_TRANSFORM, SDF_PAIR_OPS, SDF_SEGMENT_TERMS, bound_ms,
    page_bytes, page_msaa_bytes, page_msaa_work, page_work, sdf_pairs, sdf_work, solve_work,
    window_bytes, window_work)
from fontrx_torch.engine.atlas import pack_charset
from fontrx_torch.font.font import Font
from fontrx_torch.kernels import page_ref
from fontrx_torch.kernels.coverage_ref import sample_offsets
from fontrx_torch.kernels.grid import RasterGrid
from fontrx_torch.kernels.sdf_ref import sdf_batch as sdf_plain

ROOT = pathlib.Path(__file__).resolve().parents[1]
FONT = ROOT / "fontrx_torch" / "data" / "DejaVuSans.ttf"

f32 = np.float32


def _line(p0, p2):
    mid = ((p0[0] + p2[0]) / 2, (p0[1] + p2[1]) / 2)
    return [p0, mid, p2]


# a 4 x 10 square, counter-clockwise
SQUARE = np.array([_line((0, 0), (4, 0)), _line((4, 0), (4, 10)),
                   _line((4, 10), (0, 10)), _line((0, 10), (0, 0))], f32)
# y(t) = 20 t (1 - t): peak 5 at t = 0.5
PARABOLA = np.array([[[0, 0], [5, 10], [10, 0]]], f32)


def test_square_by_hand():
    # rows at 9.5, 8.5, ..., 0.5 cross both upright edges; the flat edges
    # cost their constants only
    ops, crossings = solve_work(SQUARE[None], [4], [10], 1.0, height=10,
                                row_offsets=[-0.5], columns=3)
    assert crossings == 2 * 10
    assert ops == 4 * (9 + 2) + 2 * 10 * 4 + crossings * 4 + crossings * 3


def test_parabola_by_hand():
    # rows 9..0; delta = 100 - 20 y >= 0 for y <= 5; y = 0 keeps t = 0 and
    # drops t = 1, y = 5 is a double root at t = 0.5
    ops, crossings = solve_work(PARABOLA[None], [1], [9], 1.0, height=10, row_offsets=[0.0])
    assert crossings == 1 + 4 * 2 + 2
    assert ops == (9 + 4) + 10 * 4 + 6 * 9 + crossings * 7 + crossings


def test_padding_is_not_counted():
    padded = np.concatenate([SQUARE, np.zeros((3, 3, 2), f32)])[None]
    kw = dict(height=10, row_offsets=[-0.5])
    assert solve_work(padded, [4], [10], 1.0, **kw) == solve_work(SQUARE[None], [4], [10], 1.0, **kw)
    # counted as live, a zero segment is a flat line: its constants only
    ops, crossings = solve_work(padded, [7], [10], 1.0, **kw)
    assert (ops, crossings) == (solve_work(SQUARE[None], [4], [10], 1.0, **kw)[0] + 3 * 11, 20)


def _scalar_work(segs, n, max_y, scale, height, offsets, columns, row0=0):
    """The float program, one (segment, sample row) pair at a time, on rows
    ``row0 .. row0 + height - 1``."""
    ops = crossings = 0
    for q in segs[:n].reshape(-1, 6):
        p0y, p1y, p2y = f32(q[1]), f32(q[3]), f32(q[5])
        a = p0y - f32(2) * p1y + p2y
        ops += 9 + (4 if a != 0 else 2)
        for y in range(row0, row0 + height):
            for oy in offsets:
                cy = (f32(max_y - y) + f32(oy)) / f32(scale)
                if a != 0:
                    ops += 4
                    delta = cy * a + p1y * p1y - p0y * p2y
                    if delta >= 0:
                        ops += 9
                        sq = np.sqrt(delta)
                        for t in ((p0y - p1y + sq) / a, (p0y - p1y - sq) / a):
                            if 0 <= t < 1:
                                ops, crossings = ops + 7, crossings + 1
                elif p2y != p0y:
                    ops += 4
                    t = (cy - p0y) / (p2y - p0y)
                    if 0 <= t < 1:
                        ops, crossings = ops + 4, crossings + 1
    return ops + crossings * columns, crossings


@pytest.mark.parametrize("k", [1, 2, 3])
def test_glyphs_match_the_scalar_program(k):
    size = 32
    font = Font.open(FONT)
    batch = pack_charset(font, [ord(c) for c in "Agé"])
    grids = [RasterGrid.fixed_tile(tuple(box), size, font.info.units_per_em, size)
             for box in np.asarray(batch.boxes)]
    max_y = [g.max_y for g in grids]
    offsets = [0.0] if k == 1 else sample_offsets(k)[::k, 1]
    got = solve_work(batch.segments, batch.seg_counts, max_y, grids[0].scale,
                     height=size, row_offsets=offsets, columns=k)
    want = [0, 0]
    with np.errstate(all="ignore"):
        for i, g in enumerate(grids):
            w = _scalar_work(np.asarray(batch.segments[i]), int(batch.seg_counts[i]),
                             g.max_y, g.scale, size, offsets, k)
            want = [want[0] + w[0], want[1] + w[1]]
    assert got == tuple(want) and got[1] > 0


def _two_windows(height):
    """SQUARE as a two-window stream of 5-row windows at scale 1, anchor
    ``max_y = 10`` and ``oy = -0.5`` (rows at 9.5, 8.5, ...): window 0 holds
    all four edges, window 1 the two upright ones and a padding slot."""
    win = np.zeros((1, 2 * 4, 3, 2), f32)
    win[0, :4] = SQUARE
    win[0, 4:6] = SQUARE[[1, 3]]
    return window_work(win, [[4, 2]], [10], 1.0, height=height, width=6, win_rows=5,
                       sample_offset=(0.0, -0.5))


def test_window_work_by_hand():
    # every edge is a line: 11 ops of constants per live copy; an upright
    # edge's pair costs 4, its crossing 4 and a placement; one sum a pixel
    window0 = 4 * 11 + 2 * 5 * 4 + 10 * (4 + 1)
    window1 = 2 * 11 + 2 * 5 * 4 + 10 * (4 + 1)
    assert _two_windows(10) == (window0 + window1 + 10 * 6, 20)
    # height 8 cuts window 1 to rows 5..7
    window1 = 2 * 11 + 2 * 3 * 4 + 6 * (4 + 1)
    assert _two_windows(8) == (window0 + window1 + 8 * 6, 16)


def test_window_bytes_by_hand():
    # 6 live copies of 24 B, 2 counts, one glyph's anchors, 10 x 6 int32 pixels
    assert window_bytes([[4, 2]], 10, 6) == 6 * 24 + 2 * 4 + 8 + 10 * 6 * 4
    assert window_bytes(np.zeros((3, 2), np.int32), 4, 4) == 3 * 2 * 4 + 3 * 8 + 3 * 16 * 4


@pytest.mark.parametrize("height,win_rows", [(48, 32), (32, 16)])
def test_window_work_matches_the_scalar_program(height, win_rows):
    rng = np.random.default_rng(9)
    segs = np.stack([synthetic_strokes(rng, 48) for _ in range(2)])
    scale = f32(height / UPEM)
    max_y = np.full(2, height - 1)
    n_windows = -(-height // win_rows)
    # each window holds the segments of half the glyph, in order
    win = np.zeros((2, n_windows * 48, 3, 2), f32)
    counts = np.zeros((2, n_windows), np.int32)
    for w in range(n_windows):
        part = segs[:, w % 2 * 24 : w % 2 * 24 + 24]
        win[:, w * 48 : w * 48 + 24] = part
        counts[:, w] = 24
    want = [2 * height * 40, 0]
    with np.errstate(all="ignore"):
        for w in range(n_windows):
            r0 = w * win_rows
            for b in range(2):
                o, c = _scalar_work(win[b, w * 48 :], 24, max_y[b], scale,
                                    min(win_rows, height - r0), [0.0], 1, row0=r0)
                want = [want[0] + o, want[1] + c]
    got = window_work(win, counts, max_y, scale, height=height, width=40, win_rows=win_rows)
    assert got == tuple(want) and got[1] > 0


def _page(segments, offsets, s_px=1.0):
    seg = torch.from_numpy(np.asarray(segments, f32)).reshape(-1, 3, 2).contiguous()
    return (seg, torch.zeros(len(seg), dtype=torch.int32), torch.tensor([offsets], dtype=torch.float32),
            s_px)


# y(t) spans 1002..1007 on the page: its hull misses every row of a 16-row page
FAR = np.array([[[0, 1000], [2, 1010], [4, 1000]]], f32)


def test_page_square_by_hand():
    # the square moves to x 1..5, y 2..12 on a 16 x 8 page (rows y = 15..0);
    # each upright edge's hull holds rows 2..12 and it crosses 10 of them;
    # the flat edges and the far curve need no solve
    ops, pairs, crossings = page_work(*_page(np.concatenate([SQUARE, FAR]), (1.0, 2.0)),
                                      page_h=16, page_w=8)
    assert (pairs, crossings) == (2 * 11, 2 * 10)
    constants = (PAGE_TRANSFORM + 9) * 5 + 4 * 1 + 2 * 4
    assert ops == constants + 4 * pairs + 4 * crossings + crossings + 16 * 8


def test_page_segment_off_every_row_needs_no_solve():
    ops, pairs, crossings = page_work(*_page(FAR, (0.0, 0.0)), page_h=16, page_w=8)
    assert (pairs, crossings) == (0, 0)
    assert ops == PAGE_TRANSFORM + 9 + 4 + 16 * 8
    # a band counts its own rows only
    ops, pairs, _ = page_work(*_page(SQUARE, (1.0, 2.0)), 4, page_h=16, page_w=8, out_h=4)
    assert pairs == 2 * 4 and ops > 4 * 8  # rows y = 11..8 of each upright edge


def test_page_bytes_by_hand():
    assert page_bytes(5, 1, 16, 8, "winding") == 5 * 28 + 8 + 16 * 8 * 4
    assert page_bytes(5, 1, 16, 8, "fill") == page_bytes(5, 1, 16, 8, "gray") == 5 * 28 + 8 + 128


def _scalar_solved(q, top, rows, page_w, oy=0.0, x_first=0.0):
    """The pairs the page solves, one chunk at a time: per 128-row strip
    (rows at ``y = f32(top - r) + oy``), those of the chunks (16 segments
    below a padded width of 1024, else 32) whose hull, widened by 1 px,
    meets the strip, and from 1024 reaches ``x_first``; a last chunk that is
    not full holds the point (-1e7, -1e7)."""
    pw = -(-page_w // 128) * 128
    chunk, x_cull = (32, True) if pw >= 1024 else (16, False)
    solved = np.zeros((len(q), rows), bool)
    for c0 in range(0, len(q), chunk):
        pts = q[c0 : c0 + chunk].reshape(-1, 2)
        if len(pts) < 3 * chunk:
            pts = np.concatenate([pts, np.full((1, 2), -1e7, f32)])
        ymin, ymax, xmax = f32(pts[:, 1].min()), f32(pts[:, 1].max()), f32(pts[:, 0].max())
        for r in range(rows):
            y_hi = f32(top - r // 128 * 128) + f32(oy)
            y_lo = f32(top - r // 128 * 128 - 127) + f32(oy)
            solved[c0 : c0 + chunk, r] = (ymax + f32(1) >= y_lo
                                          and ymin - f32(1) <= y_hi
                                          and (not x_cull or xmax + f32(1) >= f32(x_first)))
    return solved


def _scalar_page_work(q, top, rows, page_w, oy=0.0, x_first=0.0):
    """The page's needed pairs one at a time: solved, and in the hull or
    crossed."""
    ops = pairs = crossings = 0
    q = np.asarray(q, f32).reshape(-1, 6)
    solved = _scalar_solved(q, top, rows, page_w, oy, x_first)
    for p, solved_rows in zip(q, solved):
        p0y, p1y, p2y = f32(p[1]), f32(p[3]), f32(p[5])
        a = p0y - f32(2) * p1y + p2y
        ops += PAGE_TRANSFORM + 9 + (4 if a != 0 else 2)
        for r in np.nonzero(solved_rows)[0]:
            cy = f32(top - r) + f32(oy)
            roots, extra = 0, 0
            if a != 0:
                delta = cy * a + p1y * p1y - p0y * p2y
                if delta >= 0:
                    extra = 9
                    sq = np.sqrt(delta)
                    roots = sum(0 <= t < 1 for t in ((p0y - p1y + sq) / a, (p0y - p1y - sq) / a))
                cost = 4 + extra + 7 * roots
            elif p2y != p0y:
                roots = int(0 <= (cy - p0y) / (p2y - p0y) < 1)
                cost = 4 + 4 * roots
            else:
                continue
            if min(p0y, p1y, p2y) <= cy <= max(p0y, p1y, p2y) or roots:
                ops, pairs, crossings = ops + cost, pairs + 1, crossings + roots
    return ops, pairs, crossings


@pytest.mark.parametrize("zoom", [0.0, -0.5, 1.5])
def test_page_matches_the_scalar_program(zoom):
    from fontrx_torch.scene.layout import layout_text
    from fontrx_torch.scene.page import PageRenderer
    from fontrx_torch.scene.transform import ViewTransform

    font = Font.open(FONT)
    w, h = 96, 40
    pr = PageRenderer(font, layout_text(font, "Ag"), w, h, "cpu")
    inputs = pr.page_inputs(ViewTransform.init(2048, w, h).zoomed(zoom, (-0.2, 0.1)))
    q = page_ref.transform_segments(*inputs).reshape(-1, 6).numpy()
    with np.errstate(all="ignore"):
        ops, pairs, crossings = _scalar_page_work(q, h - 1, h, w)
    assert page_work(*inputs, page_h=h, page_w=w) == (ops + crossings + w * h, pairs, crossings)
    assert crossings > 0
    # the same crossings as the glyph path's count at these anchors
    assert solve_work(q.reshape(1, -1, 3, 2), [len(q)], [h - 1], 1.0, height=h,
                      row_offsets=[0.0])[1] == crossings


@pytest.mark.parametrize("w", [96, 1100])  # the v2 route's and K7's chunks
@pytest.mark.parametrize("zoom", [0.0, -0.5])
def test_page_msaa_matches_the_scalar_program(zoom, w):
    """Per oy, the needed pairs of one lattice, counted one at a time, with
    two placements per crossing; four tests per pixel; the constants once."""
    from fontrx_torch.scene.layout import layout_text
    from fontrx_torch.scene.page import PageRenderer
    from fontrx_torch.scene.transform import ViewTransform

    font = Font.open(FONT)
    h = 40
    pr = PageRenderer(font, layout_text(font, "Ag"), w, h, "cpu")
    inputs = pr.page_inputs(ViewTransform.init(2048, w, h).zoomed(zoom, (-0.2, 0.1)))
    q = page_ref.transform_segments(*inputs).reshape(-1, 6).numpy()
    ops = pairs = crossings = 0
    with np.errstate(all="ignore"):
        for oy, oxs in page_ref.msaa_lattice():
            o, p, c = _scalar_page_work(q, h - 1, h, w, oy, min(oxs))
            ops, pairs, crossings = ops + o + 2 * c, pairs + p, crossings + c
        constants = _scalar_page_work(q, h - 1, 0, w)[0]
    got = page_msaa_work(*inputs, page_h=h, page_w=w)
    assert got == (ops - constants + 4 * w * h, pairs, crossings)
    assert crossings > 0
    # each lattice counts as the single-sample page at its offset
    assert pairs == sum(page_work(*inputs, page_h=h, page_w=w, sample_offset=(min(oxs), oy))[1]
                        for oy, oxs in page_ref.msaa_lattice())


def test_page_msaa_bytes_by_hand():
    assert page_msaa_bytes(5, 1, 16, 8) == 5 * 28 + 8 + 16 * 8


def test_page_at_a_sample_offset_by_hand():
    # the square at x 1..5, y 2..12; rows at y = 15.25 .. 0.25: each upright
    # edge's hull holds rows y = 11.25 .. 2.25, and it crosses those 10
    ops, pairs, crossings = page_work(*_page(SQUARE, (1.0, 2.0)), page_h=16, page_w=8,
                                      sample_offset=(0.5, 0.25))
    assert (pairs, crossings) == (2 * 10, 2 * 10)


def test_page_drops_strays_where_the_chunk_misses_the_strip():
    # lines from y = 200 + 0.37 i down 20 px, their control points 2^-16 off
    # the middle: one chunk, whose hull lies in the upper of two strips,
    # with strays on rows of the lower one
    near = np.array([[10, f32(200 + 0.37 * i), 12, f32(f32(200 + 0.37 * i) - 10)
                      + f32((-1) ** i * 2.0**-16), 14, f32(f32(200 + 0.37 * i) - 20)]
                     for i in range(16)], f32)
    got = page_work(*_page(near, (0.0, 0.0)), page_h=256, page_w=8)
    with np.errstate(all="ignore"):
        ops, pairs, crossings = _scalar_page_work(near, 255, 256, 8)
    assert got == (ops + crossings + 256 * 8, pairs, crossings)
    roots, _ = page_ref.row_roots(torch.from_numpy(near), page_ref.row_coords(255, 256))
    assert int(roots[:, 128:].sum()) > 0  # strays below, which the page drops
    assert got[2] == int(roots[:, :128].sum())


def test_page_counts_stray_crossings_of_a_near_line():
    # a line from y = 200 to 100 with its control point 2^-16 off the middle
    near = np.array([[10, 200, 12, f32(150) + f32(2.0**-16), 14, 100]], f32)
    ops, pairs, crossings = page_work(*_page(near, (0.0, 0.0)), page_h=256, page_w=32)
    assert pairs > 101 and crossings > 0  # rows 100..200 and the strays


def test_bound_takes_the_larger_time():
    assert bound_ms(int(HBM_BYTES_PER_S * 1e-3), 0) == (1.0, "bytes")
    assert bound_ms(0, int(FP32_OPS_PER_S * 1e-3)) == (1.0, "operations")
    assert bound_ms(int(HBM_BYTES_PER_S * 1e-3), int(FP32_OPS_PER_S * 2e-3))[1] == "operations"


class Counted:
    """A float32 that counts every arithmetic operation and compare made on
    it (a select is free: the compare that drives it is counted)."""

    ops = 0

    def __init__(self, v):
        self.v = f32(v)

    def _op(self, other, fn, swap=False):
        Counted.ops += 1
        o = other.v if isinstance(other, Counted) else f32(other)
        return fn(o, self.v) if swap else fn(self.v, o)

    def __add__(self, o): return Counted(self._op(o, operator.add))
    def __radd__(self, o): return Counted(self._op(o, operator.add, True))
    def __sub__(self, o): return Counted(self._op(o, operator.sub))
    def __rsub__(self, o): return Counted(self._op(o, operator.sub, True))
    def __mul__(self, o): return Counted(self._op(o, operator.mul))
    def __rmul__(self, o): return Counted(self._op(o, operator.mul, True))
    def __truediv__(self, o): return Counted(self._op(o, operator.truediv))
    def __lt__(self, o): return bool(self._op(o, operator.lt))
    def __gt__(self, o): return bool(self._op(o, operator.gt))
    def __eq__(self, o): return bool(self._op(o, operator.eq))


def _sdf_segment_terms(q):
    """What one segment needs once: its terms, and per start value the
    first Newton step's ``c = (k3 t0 + k2) t0`` and ``d = (3 k3 t0 + 2 k2) t0``."""
    p0x, p0y, p1x, p1y, p2x, p2y = (Counted(v) for v in q)
    ax, ay = p1x - p0x, p1y - p0y
    bx2, by2 = p0x - 2 * p1x + p2x, p0y - 2 * p1y + p2y
    k3 = bx2 * bx2 + by2 * by2
    k2 = 3 * (ax * bx2 + ay * by2)
    k1 = 2 * (ax * ax + ay * ay)
    k3x3, k2x2 = 3 * k3, 2 * k2
    terms = (p0x, p0y, ax, ay, bx2, by2, k1, k3, k2, k3x3, k2x2, 2 * ax, 2 * ay)
    starts = [(t0, (k3 * t0 + k2) * t0, (k3x3 * t0 + k2x2) * t0)
              for t0 in (f32(1 / 6), f32(3 / 6), f32(5 / 6))]
    return terms, starts


def _sdf_pair(terms, starts, px, py):
    """The squared distance of one (segment, pixel) pair, its constant-t
    terms folded: the float values of ``csrc/sdf.cu``'s program."""
    p0x, p0y, ax, ay, bx2, by2, k1, k3, k2, k3x3, k2x2, ax2, ay2 = terms
    qx, qy = p0x - px, p0y - py
    qa = qx * ax + qy * ay
    qb = qx * bx2 + qy * by2
    k1b = k1 + qb

    def vmin(a, b):
        return a if a < b else b

    def step(t, f, df):
        df = Counted(1) if df == 0 else df
        t = t - f / df
        low, high = t < 0, t > 1
        return Counted(0) if low else Counted(1) if high else t

    def dist_sq(t):
        t2, tt = 2 * t, t * t
        dx = qx + t2 * ax + tt * bx2
        dy = qy + t2 * ay + tt * by2
        return dx * dx + dy * dy

    dx1, dy1 = qx + ax2 + bx2, qy + ay2 + by2
    best = vmin(qx * qx + qy * qy, dx1 * dx1 + dy1 * dy1)
    for t0, c, d in starts:
        t = step(Counted(t0), (c + k1b) * t0 + qa, d + k1b)
        for _ in range(2):
            t = step(t, ((k3 * t + k2) * t + k1b) * t + qa, (k3x3 * t + k2x2) * t + k1b)
        best = vmin(best, dist_sq(t))
    return best


def _sdf_scalar_work(segs, min_x, max_y, scale, h, w, spread):
    """Every pixel and segment in Python floats: the pair rule, then the
    counted program. Returns ``(ops, pairs)`` and the clamped distances."""
    Counted.ops = 0
    pairs = 0
    margin = float(f32(spread)) / float(f32(scale))
    dist = np.zeros((len(segs), h, w), f32)
    for b in range(len(segs)):
        pxs = [Counted(min_x[b] + c) / f32(scale) for c in range(w)]
        pys = [Counted(max_y[b] - r) / f32(scale) for r in range(h)]
        d2 = [[Counted(np.inf)] * w for _ in range(h)]
        for q in segs[b].reshape(-1, 6):
            if not q.any():
                continue
            xs, ys = [float(v) for v in q[0::2]], [float(v) for v in q[1::2]]
            seg_terms = None
            for r in range(h):
                for c in range(w):
                    px, py = pxs[c], pys[r]
                    dx = max(min(xs) - float(px.v), float(px.v) - max(xs), 0.0)
                    dy = max(min(ys) - float(py.v), float(py.v) - max(ys), 0.0)
                    if not dx * dx + dy * dy <= margin * margin:
                        continue
                    seg_terms = seg_terms or _sdf_segment_terms(q)
                    best = _sdf_pair(*seg_terms, px, py)
                    d2[r][c] = d2[r][c] if d2[r][c] < best else best
                    pairs += 1
        for r in range(h):
            for c in range(w):
                dist[b, r, c] = min(np.sqrt(d2[r][c].v) * f32(scale), f32(spread))
    # per pixel: the square root, * scale, min(., spread), * sign
    return (Counted.ops + len(segs) * h * w * 4, pairs), dist


@pytest.mark.parametrize("spread", [8.0, 2.5])
def test_sdf_ops_match_the_scalar_program(spread):
    """A square and a parabola on a 20 x 36 raster at scale 1/4: a segment
    near no pixel and a padding row. The folded program gives the plain
    version's distances bit for bit."""
    segs = np.zeros((1, 6, 3, 2), f32)
    segs[0, :4] = SQUARE * 8 + 4
    segs[0, 4] = PARABOLA[0] * 2 + [200, 0]
    scale = f32(0.25)
    args = (segs, np.array([-2], np.int32), np.array([18], np.int32), scale)
    got = sdf_work(*args, height=20, width=36, spread_px=spread)
    with np.errstate(all="ignore"):
        want, dist = _sdf_scalar_work(*args, 20, 36, spread)
    assert got == want
    assert 0 < got[1] < 5 * 20 * 36  # the rule drops pairs
    assert sdf_pairs(*args, height=20, width=36, spread_px=spread)[0, 4] == 0  # the parabola
    plain = sdf_plain(*(torch.from_numpy(a) for a in args[:3]), float(scale), height=20,
                      width=36, spread_px=spread).abs().numpy()
    np.testing.assert_array_equal(dist.view(np.int32), plain.view(np.int32))


def test_sdf_pair_ops_by_hand():
    # set-up 9, dist_sq at 0 (3) and 1 (7) and their min; per start a first
    # step at t0 (9), two steps of 15, dist_sq (13) and a min; then the min
    # into d2
    assert SDF_PAIR_OPS == 9 + 3 + 7 + 1 + 3 * (9 + 2 * 15 + 13 + 1) + 1 == 180
    assert SDF_SEGMENT_TERMS == 21 + 2 + 3 * 6


def random_sdf_batch(size):
    """The JAX package's SDF test batch (96 random quadratics, 5 padding
    rows, ``min_x = 3``)."""
    rng = np.random.default_rng(1234)
    p0 = rng.uniform(100, 1900, (3, 96, 2))
    p1 = p0 + rng.uniform(-80, 80, (3, 96, 2))
    p2 = p0 + rng.uniform(-80, 80, (3, 96, 2))
    seg = np.stack([p0, p1, p2], 2).astype(f32)
    seg[:, -5:] = 0.0
    return seg, np.full(3, 3, np.int32), np.full(3, size - 1, np.int32), f32(size / 2048)


@pytest.mark.parametrize("size", [32, 64])
def test_sdf_pairs_within_the_tile_lists(size):
    """The needed pairs, per segment, against a loop over segments in
    NumPy; in all, fewer than K11's 16 x 16 tile lists cover."""
    from fontrx.kernels.sdf_pallas import pack_sdf_tiles

    seg, min_x, max_y, scale = random_sdf_batch(size)
    counts = sdf_pairs(seg, min_x, max_y, scale, height=size, width=size).numpy()
    margin = 8.0 / float(scale)
    for b in range(3):
        px = ((min_x[b] + np.arange(size)).astype(f32) / scale).astype(np.float64)
        py = ((max_y[b] - np.arange(size)).astype(f32) / scale).astype(np.float64)
        for s in range(96):
            hull = seg[b, s].astype(np.float64)
            dx = np.maximum(np.maximum(hull[:, 0].min() - px, px - hull[:, 0].max()), 0)
            dy = np.maximum(np.maximum(hull[:, 1].min() - py, py - hull[:, 1].max()), 0)
            want = 0 if s >= 91 else int((dx[None] ** 2 + dy[:, None] ** 2 <= margin ** 2).sum())
            assert counts[b, s] == want
    chunk = 8
    stream, _cnts, _tile_ids, cap = pack_sdf_tiles(seg, min_x, max_y, scale, size, size,
                                                   tile_h=16, tile_w=16, seg_chunk=chunk)
    listed = int((stream.reshape(-1, 6) != 0).any(axis=-1).sum()) * 256
    _ops, pairs = sdf_work(seg, min_x, max_y, scale, height=size, width=size)
    assert 0 < pairs == counts.sum() < listed
