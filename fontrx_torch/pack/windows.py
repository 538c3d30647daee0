"""Window-packed segment streams for the small-tile atlas path.

A bounded copy of ``fontrx/kernels/winding_dense.py::pack_dense_windows``
(``:488-548``) and of the row height of ``dense_win_tuning`` (``:70-81``).
Window ``w`` owns the pixel rows ``[w * win_rows, (w + 1) * win_rows)``.
Each segment is copied into every window that its control hull's y-range,
widened by one font unit and then by ``sample_margin`` pixels, can reach;
the windowed winding (``kernels.winding_ref.winding_windows_batch``) solves
each copy on its own window's rows only. So the row assignment defines the
function, and it is the reference's op for op: float64 bounds, ``scale``
as the float32 value, ``floor``/``ceil`` and the floor division before the
clip. Within a window the copies are sorted by x-span midpoint, stably, as
the reference sorts them (the order does not change an integer sum).

What is not copied: the reference rounds ``cap`` up to its TPU lane
quantum (``groups * seg_chunk``). Here ``counts`` says how many copies of
each window are live, so the kernel stops there, and ``cap`` is the largest
count. The reference's unused ``min_x`` and its one-valued
``sample_margin`` are gone.
"""

from __future__ import annotations

import numpy as np

# the rows carry this many pixels on each side, so the pack serves every
# sample offset with |oy| <= SAMPLE_MARGIN
SAMPLE_MARGIN = 1.0


def win_rows_for(height: int) -> int:
    """Rows per window at a tile height: ``dense_win_tuning``'s row height
    (16 at <= 32 px, 32 at <= 64 px, else 128)."""
    if height <= 32:
        return 16
    if height <= 64:
        return 32
    return 128


def pack_windows(segments, max_y, scale: float, height: int, *, win_rows: int):
    """Window-major stream of a ``[B, S, 3, 2]`` batch.

    ``scale`` is the float32 scale as a Python float (``float(np.float32(
    size / upem))``). Returns ``(segments_win, counts, n_windows, cap)``:
    float32 ``[B, n_windows * cap, 3, 2]`` with window ``w``'s ``counts[b,
    w]`` live copies first in its slots ``[w * cap, (w + 1) * cap)`` and
    zeros after them, and int32 ``[B, n_windows]``. All-zero segments are
    in no window.
    """
    seg = np.asarray(segments, np.float32)
    b, s = seg.shape[0], seg.shape[1]
    n_windows = max((height + win_rows - 1) // win_rows, 1)
    max_y = np.asarray(max_y, np.float64).reshape(b)
    ys = seg[:, :, :, 1].astype(np.float64)
    lo = ys.min(axis=2) - 1.0     # [B, S] hull - guard
    hi = ys.max(axis=2) + 1.0
    # rows r with cy(r) = (max_y - r + oy) / scale inside [lo, hi]
    r_lo = np.floor(max_y[:, None] - scale * hi) - SAMPLE_MARGIN
    r_hi = np.ceil(max_y[:, None] - scale * lo) + SAMPLE_MARGIN
    w_lo = np.clip(r_lo // win_rows, 0, n_windows - 1).astype(np.int64)
    w_hi = np.clip(r_hi // win_rows, 0, n_windows - 1).astype(np.int64)
    dead = (seg == 0.0).all(axis=(2, 3))
    xmid = seg[:, :, :, 0].min(axis=2) + seg[:, :, :, 0].max(axis=2)

    w = np.arange(n_windows)[None, :, None]
    member = (w_lo[:, None, :] <= w) & (w <= w_hi[:, None, :]) & ~dead[:, None, :]
    counts = member.sum(axis=2).astype(np.int32)  # [B, nw]
    # members first, each window's by x midpoint; lexsort is stable, so ties
    # keep the segment order, as the reference's stable argsort does
    keys = np.broadcast_to(xmid[:, None, :], member.shape)
    order = np.lexsort((keys, ~member), axis=-1)  # [B, nw, S]

    cap = max(int(counts.max(initial=0)), 1)
    live = np.arange(min(cap, s))[None, None, :] < counts[:, :, None]
    picked = seg[np.arange(b)[:, None, None], order[:, :, :cap]]  # [B, nw, <= cap, 3, 2]
    out = np.zeros((b, n_windows, cap, 3, 2), np.float32)
    out[:, :, : min(cap, s)] = np.where(live[..., None, None], picked, np.float32(0))
    return out.reshape(b, n_windows * cap, 3, 2), counts, n_windows, cap
