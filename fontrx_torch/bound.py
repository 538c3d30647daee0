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
"""

from __future__ import annotations

import numpy as np

# The card's peaks (NVIDIA's H100 SXM data sheet, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

f32 = np.float32


def solve_work(segments, seg_counts, max_y, scale, *, height, row_offsets, columns=1):
    """FP32 operations and crossings of the root solves these inputs need.

    ``segments`` float32 ``[B, S, 3, 2]`` with ``seg_counts[b]`` live
    segments in glyph ``b``; ``max_y`` int ``[B]``; ``scale`` the shared
    float32 scale. Sample row ``y`` of glyph ``b`` at offset ``oy`` of
    ``row_offsets`` lies at em-space ``(f32(max_y[b] - y) + oy) / scale``,
    as in the kernels. ``columns`` is the number of sub-columns each
    crossing is placed among. Returns ``(ops, crossings)``.
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
            rows = (int(max_y[b]) - np.arange(height)).astype(f32)
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


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    """The bound in ms, and what binds it: ``"bytes"`` or ``"operations"``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"
