"""fontrx_torch.bound counts the root-solve work these inputs need: by hand on
a square and a parabola, and against a scalar loop over the float program
on glyphs of DejaVu Sans."""

import pathlib

import numpy as np
import pytest

from fontrx_torch.bound import FP32_OPS_PER_S, HBM_BYTES_PER_S, bound_ms, solve_work
from fontrx_torch.engine.atlas import pack_charset
from fontrx_torch.font.font import Font
from fontrx_torch.kernels.coverage_ref import sample_offsets
from fontrx_torch.kernels.grid import RasterGrid

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


def _scalar_work(segs, n, max_y, scale, height, offsets, columns):
    """The float program, one (segment, sample row) pair at a time."""
    ops = crossings = 0
    for q in segs[:n].reshape(-1, 6):
        p0y, p1y, p2y = f32(q[1]), f32(q[3]), f32(q[5])
        a = p0y - f32(2) * p1y + p2y
        ops += 9 + (4 if a != 0 else 2)
        for y in range(height):
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


def test_bound_takes_the_larger_time():
    assert bound_ms(int(HBM_BYTES_PER_S * 1e-3), 0) == (1.0, "bytes")
    assert bound_ms(0, int(FP32_OPS_PER_S * 1e-3)) == (1.0, "operations")
    assert bound_ms(int(HBM_BYTES_PER_S * 1e-3), int(FP32_OPS_PER_S * 2e-3))[1] == "operations"
