"""The least time an H100 could take for a raster kernel's work: its bound.

The bound is the larger of two times: the bytes the function must move
(each input read once, each output written once) over the card's memory
rate, and the FP32 operations it needs on these inputs over the card's
FP32 rate. The operations are counted from the data, not from the most a
shape could need: the float program of the root solve
(``csrc/crossings.cuh``) is run here in NumPy float32, with the kernels'
association, and each branch is counted only where these inputs take it.

Per live segment, once (its constants): ``a``, ``ax``, ``bx`` and the test
``a == 0`` (9), then ``p1y*p1y``, ``p0y*p2y``, ``p0y - p1y`` and
``p1y - p0y`` for a quadratic (4), or ``p2y - p0y`` and its test for a
line (2).

Per (segment, sample row) pair:

- quadratic: the discriminant ``y*a + p1y*p1y - p0y*p2y`` and its test
  (4); where it is >= 0, the square root, the two roots and their
  ``[0, 1)`` tests (9); per root in ``[0, 1)``, ``xx`` (4) and ``dy`` with
  its test (3);
- line (``a == 0``, ``p2y != p0y``): ``t`` and its ``[0, 1)`` test (4);
  per root in ``[0, 1)``, ``xx`` (4);
- flat line: nothing.

Per crossing and sub-column, one operation places it among the columns.
Per sample, one operation sums or tests its winding. Divides and square
roots count as one operation each, so the bound is a floor.

The SDF's distance program (``csrc/sdf.cu``) has no branch that depends on
the data. Its work is the (segment, pixel) pairs the function needs times
the least count of operations per pair (``SDF_PAIR_OPS``), plus the terms
each segment needs once and a few operations per pixel (``sdf_work``). A
pair is needed when the pixel's sample point lies within the spread of the
segment's control hull box: the curve lies inside its hull, so a segment
farther off cannot change the clamped result, whatever a kernel culls
(``sdf_pairs``). What depends only on the segment and a constant ``t``
(``t = 0``, ``t = 1`` and the Newton start values) is counted once per
segment, not per pair.

The Loop-Blinn fill (``csrc/loopblinn.cu``) needs, per triangle that can
draw (class 0, 1 or 2), its area, sign, ``area != 0`` test and reciprocal
(``LB_TRIANGLE_SETUP``), and per (triangle, pixel) pair whose pixel is
inside the triangle, as the plain version's own ``inside`` says, the
barycentric weights, ``u``, ``v`` and the class test of a curve triangle
(``LB_CURVE_PAIR``); a solid triangle's pair needs none of them. The edge
tests that find the inside pairs are not counted: how many of them a
rasterizer runs depends on how it walks the pixels, so the count does not
depend on any tiling (``loopblinn_work``). Its bytes are a triangle's 12
floats and class where it can draw, only the class of a padding row, the
anchors and one byte per pixel of output (``loopblinn_bytes``).

The windowed winding (``winding_windows()`` in ``csrc/winding.cu``, K3)
needs the root solves of each window's live copies on that window's rows
only, as the stream defines its function, one placement per crossing and
one sum per pixel (``window_work``); its bytes are the live copies, the
window counts, the anchors and the int32 output (``window_bytes``).

The direct page render (``csrc/page.cu``) needs, per segment of the
em-space stream, its transform to page pixels (a multiply-add per
coordinate, counted as two operations) and its constants as above; per
(segment, row) pair that it needs, the solve of its branch as above; one
operation per crossing and one per pixel (``page_work``). A pair is needed
when the page solves it (the reference's chunk cull, ``page_ref``) and its
row's sample y lies in the segment's control-hull y-range, or the float
program gives it a root in ``[0, 1)`` all the same: a nearly straight
quadratic's rounded roots can stray off its hull, and they change the page.
Its bytes are the em-space stream (24 B a segment and a 4 B owner), 8 B per
instance offset and the output once: 4 B a pixel for the int32 winding, 1 B
for the fill or gray (``page_bytes``). The 2 x 2 MSAA page
(``page_msaa_work``) needs the transform and constants once, the needed
pairs of both row lattices (one per ``oy``), two placements per crossing
(one per x sample) and four tests per pixel; its bytes are the same stream,
offsets and uint8 page (``page_msaa_bytes``).
"""

from __future__ import annotations

import numpy as np
import torch

from fontrx_torch.kernels import loopblinn_ref, page_ref, winding_ref

# The card's peaks (NVIDIA's H100 SXM data sheet, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

f32 = np.float32


def solve_work(segments, seg_counts, max_y, scale, *, height, row_offsets, columns=1, row0=0):
    """FP32 operations and crossings of the root solves these inputs need.

    ``segments`` float32 ``[B, S, 3, 2]`` with ``seg_counts[b]`` live
    segments in glyph ``b``; ``max_y`` int ``[B]``; ``scale`` the shared
    float32 scale. Sample row ``y`` (``row0 <= y < row0 + height``) of glyph
    ``b`` at offset ``oy`` of ``row_offsets`` lies at em-space
    ``(f32(max_y[b] - y) + oy) / scale``, as in the kernels. ``columns`` is
    the number of sub-columns each crossing is placed among. Returns
    ``(ops, crossings)``.
    """
    seg = np.asarray(segments, f32)
    counts = np.asarray(seg_counts, np.int64)
    scale = f32(scale)
    offsets = np.asarray(row_offsets, f32)
    ops = crossings = 0
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for b in range(seg.shape[0]):
            q = seg[b, : counts[b]].reshape(-1, 6)
            p0y, p1y, p2y = (q[:, i, None] for i in (1, 3, 5))
            rows = (int(max_y[b]) - (row0 + np.arange(height))).astype(f32)
            cy = ((rows[:, None] + offsets[None, :]) / scale).reshape(1, -1)

            a = p0y - f32(2) * p1y + p2y
            quad = (a != 0)[:, 0]
            lin = ~quad & (p2y != p0y)[:, 0]
            ops += 9 * len(q) + 4 * int(quad.sum()) + 2 * int((~quad).sum())

            # quadratic: ((y*a + p1y*p1y) - p0y*p2y), then the two roots
            a_q, p0y_q, p1y_q = a[quad], p0y[quad], p1y[quad]
            delta = cy * a_q + p1y_q * p1y_q - p0y_q * p2y[quad]
            live = delta >= 0
            sq = np.sqrt(np.where(live, delta, f32(0)))
            py01 = p0y_q - p1y_q
            roots = 0
            for t in ((py01 + sq) / a_q, (py01 - sq) / a_q):
                roots += int((live & (t >= 0) & (t < 1)).sum())
            ops += 4 * delta.size + 9 * int(live.sum()) + 7 * roots
            crossings += roots

            # line: t = (y - p0y) / (p2y - p0y)
            t = (cy - p0y[lin]) / (p2y[lin] - p0y[lin])
            roots = int(((t >= 0) & (t < 1)).sum())
            ops += 4 * t.size + 4 * roots
            crossings += roots
    return ops + crossings * columns, crossings


# bytes of the window-packed stream: a live copy's six float32 coordinates,
# a window's int32 count, a glyph's two int32 anchors, an int32 pixel
WINDOW_COPY_BYTES = 6 * 4
WINDOW_COUNT_BYTES = 4
WINDOW_ANCHOR_BYTES = 2 * 4


def window_work(segments_win, counts, max_y, scale, *, height, width, win_rows,
                sample_offset=(0.0, 0.0)):
    """FP32 operations and crossings of the windowed winding (K3's function,
    ``winding_ref.winding_windows_batch``) on these inputs: each window's
    live copies solved on its rows below ``height`` only, as ``solve_work``
    counts a solve, one placement per crossing and one sum per pixel.
    ``segments_win`` float32 ``[B, n_windows * cap, 3, 2]``, ``counts``
    ``[B, n_windows]``. Returns ``(ops, crossings)``."""
    seg = np.asarray(segments_win, f32)
    counts = np.asarray(counts)
    b, n_windows = counts.shape
    cap = seg.shape[1] // max(n_windows, 1)
    ops = crossings = 0
    for w in range(n_windows):
        r0, r1 = w * win_rows, min((w + 1) * win_rows, height)
        if r0 >= r1:
            continue
        o, c = solve_work(seg[:, w * cap : (w + 1) * cap], counts[:, w], max_y, scale,
                          height=r1 - r0, row_offsets=[sample_offset[1]], row0=r0)
        ops, crossings = ops + o, crossings + c
    return ops + b * height * width, crossings


def window_bytes(counts, height: int, width: int) -> int:
    """Bytes the windowed winding must move: 24 B per live copy, 4 B per
    window count, 8 B of anchors per glyph and 4 B per output pixel."""
    counts = np.asarray(counts)
    b, n_windows = counts.shape
    return (int(counts.sum()) * WINDOW_COPY_BYTES + b * n_windows * WINDOW_COUNT_BYTES
            + b * WINDOW_ANCHOR_BYTES + b * height * width * 4)


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    """The bound in ms, and what binds it: ``"bytes"`` or ``"operations"``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# Operations of the SDF program (csrc/sdf.cu) at their least, a compare or
# a select of the clamp and the min counting one each, with the starts and
# steps of the Pallas kernel (sdf_pallas.py:42-43):
SDF_STARTS = 3
SDF_ITERS = 3
# per (segment, pixel) pair: qx, qy, qa, qb and k1b
SDF_PAIR_SETUP = 9
# dist_sq(0) = qx*qx + qy*qy
SDF_DIST_SQ_0 = 3
# dist_sq(1): (qx + 2 ax) + bx2, the same in y, dx*dx + dy*dy
SDF_DIST_SQ_1 = 7
# dist_sq(t): 2t, t*t, dx and dy (4 each), dx*dx + dy*dy
SDF_DIST_SQ = 13
# the first Newton step, at the start value t0: f = (c + k1b)*t0 + qa and
# df = d + k1b, with c and d per segment (4), df == 0 (1), t - f/df (2),
# the clamp (2)
SDF_NEWTON_FIRST = 9
# a later step: f (6), df (4), df == 0 (1), t - f/df (2), the clamp (2)
SDF_NEWTON_STEP = 15
# the set-up, dist_sq at 0 and 1 and their min; per start the steps,
# dist_sq and a min; the min into the pixel's running d2
SDF_PAIR_OPS = (SDF_PAIR_SETUP + SDF_DIST_SQ_0 + SDF_DIST_SQ_1 + 1
                + SDF_STARTS * (SDF_NEWTON_FIRST + (SDF_ITERS - 1) * SDF_NEWTON_STEP
                                + SDF_DIST_SQ + 1) + 1)
# per segment: ax, ay, bx2, by2, k3, k2, k1, 3 k3, 2 k2 (21), 2 ax and 2 ay
# (2), per start c = (k3 t0 + k2) t0 and d = (3 k3 t0 + 2 k2) t0 (6)
SDF_SEGMENT_TERMS = 21 + 2 + 6 * SDF_STARTS
# per pixel: the square root, * scale, min(., spread), * sign; per column
# and per row of a glyph, the divide of its sample coordinate
SDF_PIXEL = 4
SDF_LINE = 1

# (glyph, segment, pixel) elements of one chunk of the pair count
_PAIR_CHUNK = 1 << 25


def sdf_pairs(segments, min_x, max_y, scale, *, height, width, spread_px=8.0):
    """Per live segment, the pixels whose sample point lies within
    ``spread_px`` of its control hull box: int64 ``[B, S]``.

    Tensors or arrays; the count runs on the tensors' device, in float64
    from the float32 sample points (``winding_ref.sample_coords``) and hull
    boxes: ``dx*dx + dy*dy <= (spread / scale)**2`` with ``dx``, ``dy`` the
    distances from the point to the box along each axis.
    """
    seg = torch.as_tensor(segments)
    dev = seg.device
    min_x = torch.as_tensor(min_x, dtype=torch.int32, device=dev)
    max_y = torch.as_tensor(max_y, dtype=torch.int32, device=dev)
    px, py = winding_ref.sample_coords(min_x, max_y, scale, height=height, width=width)
    dead = (seg == 0).flatten(-2).all(dim=-1)  # [B, S]
    hull = seg.double()
    h0 = hull.amin(dim=2).masked_fill(dead[..., None], torch.inf)  # [B, S, 2]
    h1 = hull.amax(dim=2).masked_fill(dead[..., None], -torch.inf)

    def axis_sq(lo, hi, p):  # [B, S], [B, S], [B, N] -> [B, S, N]
        p = p.double()[:, None, :]
        d = torch.maximum(torch.maximum(lo[..., None] - p, p - hi[..., None]),
                          torch.zeros((), dtype=torch.float64, device=dev))
        return d * d

    dx2 = axis_sq(h0[..., 0], h1[..., 0], px)  # [B, S, W]
    dy2 = axis_sq(h0[..., 1], h1[..., 1], py)  # [B, S, H]
    margin = float(f32(spread_px)) / float(f32(scale))
    b, s = dead.shape
    counts = torch.zeros((b, s), dtype=torch.int64, device=dev)
    step = max(1, _PAIR_CHUNK // max(s * height * width, 1))
    for b0 in range(0, b, step):
        d2 = dy2[b0 : b0 + step, :, :, None] + dx2[b0 : b0 + step, :, None, :]
        counts[b0 : b0 + step] = (d2 <= margin * margin).sum(dim=(2, 3))
    return counts


def sdf_work(segments, min_x, max_y, scale, *, height, width, spread_px=8.0):
    """FP32 operations of the SDF on these inputs, and the (segment, pixel)
    pairs it needs: ``(ops, pairs)``."""
    counts = sdf_pairs(segments, min_x, max_y, scale, height=height, width=width,
                       spread_px=spread_px)
    pairs = int(counts.sum())
    segs = int((counts > 0).sum())
    b = counts.shape[0]
    ops = (pairs * SDF_PAIR_OPS + segs * SDF_SEGMENT_TERMS
           + b * height * width * SDF_PIXEL + b * (height + width) * SDF_LINE)
    return ops, pairs


# Loop-Blinn, per triangle that can draw: area = (bx - ax)*(cy - ay) -
# (by - ay)*(cx - ax) (7), its sign (1), area != 0 (1), 1/area (1)
LB_TRIANGLE_SETUP = 10
# per inside pair of a curve triangle: la, lb (2), lc (2), u and v (5 each),
# q = (1 + u) - v (2), f = q*q (1), 4u (1), the class compare (1)
LB_CURVE_PAIR = 19
# a triangle's 3 corners x (x, y, u, v) in float32 and its int32 class; a
# padding row's class alone; a glyph's int32 min_x and max_y
LB_CLASS_BYTES = 4
LB_TRIANGLE_BYTES = 3 * 4 * 4 + LB_CLASS_BYTES
LB_ANCHOR_BYTES = 2 * 4


def loopblinn_bytes(classes, height, width):
    """Bytes the Loop-Blinn fill must move: per triangle that can draw
    (class 0, 1 or 2) its 12 float32 coordinates and its int32 class
    (``LB_TRIANGLE_BYTES``), per padding row only its class, per glyph its
    two int32 anchors, and one byte per output pixel."""
    classes = torch.as_tensor(classes)
    live = int(((classes >= loopblinn_ref.CLASS_CONCAVE)
                & (classes <= loopblinn_ref.CLASS_SOLID)).sum())
    b = classes.shape[0]
    return (live * LB_TRIANGLE_BYTES + (classes.numel() - live) * LB_CLASS_BYTES
            + b * LB_ANCHOR_BYTES + b * height * width)


def loopblinn_work(tris, classes, min_x, max_y, scale, *, height, width,
                   sample_offset=(0.0, 0.0)):
    """FP32 operations of the Loop-Blinn fill on these inputs, and the
    (triangle, pixel) pairs whose pixel is inside the triangle:
    ``(ops, inside_pairs)``. Tensors; the count runs on their device, with
    the plain version's ``inside``."""
    classes = torch.as_tensor(classes)
    live = (classes >= loopblinn_ref.CLASS_CONCAVE) & (classes <= loopblinn_ref.CLASS_SOLID)
    curve = live & (classes <= loopblinn_ref.CLASS_CONVEX)
    pairs = curve_pairs = 0
    for (bi, mi, _, _), *_ in loopblinn_ref.inside_pairs(
            tris, min_x, max_y, scale, height=height, width=width,
            sample_offset=sample_offset):
        pairs += len(bi)
        curve_pairs += int(curve[bi, mi].sum())
    ops = int(live.sum()) * LB_TRIANGLE_SETUP + curve_pairs * LB_CURVE_PAIR
    return ops, pairs


# per segment of the page stream: a multiply-add per coordinate
PAGE_TRANSFORM = 2 * 6
# bytes per segment of the em-space stream and its int32 owner, per
# instance offset
PAGE_SEGMENT_BYTES = 6 * 4 + 4
PAGE_OFFSET_BYTES = 2 * 4

# (segment, row) pairs of one chunk of the page count
_PAGE_PAIR_CHUNK = 1 << 22


def page_bytes(segments: int, instances: int, out_h: int, page_w: int, mode: str = "fill"):
    """Bytes the direct page render must move: the em-space stream, the
    instance offsets and the output, 4 B a pixel for ``mode="winding"``,
    else 1 B."""
    per_pixel = 4 if mode == "winding" else 1
    return (segments * PAGE_SEGMENT_BYTES + instances * PAGE_OFFSET_BYTES
            + out_h * page_w * per_pixel)


def page_work(flat_segments, seg_inst_idx, inst_offsets, s_px, band_y0=0, *, page_h, page_w,
              out_h=None, sample_offset=(0.0, 0.0)):
    """FP32 operations of the direct page render on these inputs at the
    sample offset ``(ox, oy)``, the (segment, row) pairs it needs and its
    crossings: ``(ops, pairs, crossings)``. A pair is needed where the page
    solves it (``page_ref.solved_rows``) and its row lies in the segment's
    control-hull y-range or gets a crossing. Tensors, as
    ``page_ref.direct_page`` takes them; the count runs on their device."""
    oh = page_h if out_h is None else out_h
    ox, oy = sample_offset
    q = page_ref.transform_segments(flat_segments, seg_inst_idx, inst_offsets,
                                    s_px).reshape(-1, 6)
    ops, pairs, crossings = _page_pairs(q, page_h - 1 - band_y0, oh, page_w, oy, (ox,))
    return _page_constants(q) + ops + crossings + oh * page_w, pairs, crossings


def page_msaa_work(flat_segments, seg_inst_idx, inst_offsets, s_px, *, page_h, page_w):
    """FP32 operations of the 2 x 2 MSAA page on these inputs, the (segment,
    row) pairs it needs over both row lattices and their crossings:
    ``(ops, pairs, crossings)``. Each segment's transform and constants
    count once; each pair needed on the lattice of an ``oy`` (as the pair
    function solves it, ``page_ref.windings``) its solve once; each crossing
    one placement per x sample; each pixel one test per sample."""
    q = page_ref.transform_segments(flat_segments, seg_inst_idx, inst_offsets,
                                    s_px).reshape(-1, 6)
    ops, pairs, crossings = _page_constants(q), 0, 0
    for oy, oxs in page_ref.msaa_lattice():
        o, p, c = _page_pairs(q, page_h - 1, page_h, page_w, oy, oxs)
        ops, pairs, crossings = ops + o + c * len(oxs), pairs + p, crossings + c
    return ops + 4 * page_h * page_w, pairs, crossings


def page_msaa_bytes(segments: int, instances: int, page_h: int, page_w: int):
    """Bytes the MSAA page must move: the em-space stream, the instance
    offsets and the uint8 page, once."""
    return page_bytes(segments, instances, page_h, page_w, "fill")


def _page_constants(q):
    """Operations each page-space segment ``q`` needs once: its transform
    and its constants."""
    p0y, p1y, p2y = q[:, 1], q[:, 3], q[:, 5]
    n_quad = int(((p0y - 2 * p1y + p2y) != 0).sum())
    return (PAGE_TRANSFORM + 9) * len(q) + 4 * n_quad + 2 * (len(q) - n_quad)


def _page_pairs(q, top: int, rows: int, page_w: int, oy, oxs):
    """The solves of the page's needed pairs on ``rows`` rows (row 0 at
    ``y = f32(top) + oy``, the page at the x offsets ``oxs``): ``(ops,
    pairs, crossings)``."""
    cy = page_ref.row_coords(top, rows, q.device, oy)
    strips = page_ref.strip_table(q, top, rows, page_w, oy, oxs)
    row_strip = torch.arange(rows, device=q.device) // page_ref.STRIP_ROWS
    p0y, p1y, p2y = q[:, 1], q[:, 3], q[:, 5]
    quad = (p0y - 2 * p1y + p2y) != 0
    lin = ~quad & (p2y != p0y)
    ops = pairs = crossings = 0
    step = max(1, _PAGE_PAIR_CHUNK // max(rows, 1))
    for s0 in range(0, len(q), step):
        qc = q[s0 : s0 + step]
        roots, live = page_ref.row_roots(qc, cy)
        solved = strips[s0 : s0 + step][:, row_strip]
        roots = roots * solved
        ys = qc[:, 1::2]
        needed = solved & (((cy[None, :] >= ys.amin(dim=1)[:, None])
                            & (cy[None, :] <= ys.amax(dim=1)[:, None])) | (roots > 0))
        nq = needed & quad[s0 : s0 + step, None]
        nl = needed & lin[s0 : s0 + step, None]
        ops += (4 * int(nq.sum()) + 9 * int((live & nq).sum()) + 7 * int((roots * nq).sum())
                + 4 * int(nl.sum()) + 4 * int((roots * nl).sum()))
        pairs += int((nq | nl).sum())
        crossings += int(roots.sum())
    return ops, pairs, crossings
