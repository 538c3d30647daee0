"""Entry point: the raster step of the glyph fill path and an example batch.

The port of ``__graft_entry__.entry()``: the same 128 x 640 raster of the
same example batch, through ``RasterEngine.winding_batch``.
"""

from __future__ import annotations

import numpy as np
import torch

from fontrx_torch.convert import to_device
from fontrx_torch.engine.raster import RasterEngine

HEIGHT, WIDTH = 128, 640


def _example_batch(b=8, s=64, tile=128):
    """Deterministic batch of synthetic quadratic segments (no font file
    dependency): simple closed diamonds with curved sides."""
    rng = np.random.default_rng(0)
    segments = np.zeros((b, s, 3, 2), np.float32)
    for i in range(b):
        n = 4
        corners = np.array(
            [[100, 0], [200, 100], [100, 200], [0, 100]], np.float32
        ) + rng.integers(0, 20, (4, 2))
        for k in range(n):
            p0 = corners[k]
            p2 = corners[(k + 1) % n]
            p1 = (p0 + p2) / 2 + rng.integers(-30, 30, 2)
            segments[i, k] = [p0, p1, p2]
    min_x = np.full(b, -1, np.int32)
    max_y = np.full(b, tile - 2, np.int32)
    scale = np.float32(0.5)
    return segments, min_x, max_y, scale


def entry(device="cuda"):
    """Returns ``(fn, example_args)``: ``fn(*example_args)`` rasters the
    example batch on ``device`` and returns its float32 ``[8, 128, 640]``
    nonzero mask."""
    engine = RasterEngine(device=device)

    def fn(segments, min_x, max_y, scale):
        winding_map = engine.winding_batch(
            segments, min_x, max_y, scale, height=HEIGHT, width=WIDTH
        )
        return (winding_map != 0).to(torch.float32)

    return fn, to_device(*_example_batch(tile=HEIGHT), device)
