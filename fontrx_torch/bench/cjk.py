"""The CJK-regime batch: high segment counts per glyph.

A copy of the batch makers of ``benchmarks/cjk.py`` (``:33-67``), so that
the port builds the reference's 1000-glyph x 288-segment atlas without the
JAX package's benchmarks: ``UPEM``, ``synthetic_strokes`` and
``make_batch``, array-equal to the originals
(``tests/test_torch_windows.py``).
"""

from __future__ import annotations

import numpy as np

UPEM = 2048


def synthetic_strokes(rng, n_segments: int, y_sorted: bool = True) -> np.ndarray:
    """``[n_segments, 3, 2]`` float32: closed 4-segment diamond strokes
    (winding-valid contours) at random positions over the em box, with
    curved sides. ``y_sorted`` orders strokes bottom-to-top."""
    n_shapes = n_segments // 4
    cx = rng.integers(100, UPEM - 100, n_shapes)
    cy = rng.integers(100, UPEM - 100, n_shapes)
    if y_sorted:
        order = np.argsort(cy)
        cx, cy = cx[order], cy[order]
    r = rng.integers(20, 90, n_shapes)
    segs = np.zeros((n_shapes, 4, 3, 2), np.float32)
    for k in range(4):
        a0 = k * np.pi / 2
        a1 = (k + 1) * np.pi / 2
        p0 = np.stack([cx + r * np.cos(a0), cy + r * np.sin(a0)], axis=1)
        p2 = np.stack([cx + r * np.cos(a1), cy + r * np.sin(a1)], axis=1)
        mid = (p0 + p2) / 2
        bulge = rng.integers(-15, 15, (n_shapes, 2))
        segs[:, k, 0] = np.round(p0)
        segs[:, k, 1] = np.round(mid + bulge)
        segs[:, k, 2] = np.round(p2)
    # close exactly: each side's p2 is the next side's p0
    for k in range(4):
        segs[:, (k + 1) % 4, 0] = segs[:, k, 2]
    return segs.reshape(-1, 3, 2)[:n_segments]


def make_batch(b: int, n_segments: int, seed: int = 7) -> np.ndarray:
    """``b`` glyphs of ``synthetic_strokes``: float32 ``[b, n_segments, 3, 2]``."""
    rng = np.random.default_rng(seed)
    return np.stack([synthetic_strokes(rng, n_segments) for _ in range(b)])
