"""Carry raster inputs across: host batches and grids, or NumPy arrays,
become tensors on a device."""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from fontrx_torch.kernels.grid import RasterGrid
from fontrx_torch.pack.segments import PackedBatch


def _tensor(x, np_dtype, dtype, device) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x, np_dtype))
    return x.to(device=device, dtype=dtype).contiguous()


def to_device(segments, min_x, max_y, scale, device):
    """``(segments f32 [B,S,3,2], min_x i32 [B], max_y i32 [B], scale)`` on
    ``device``. Accepts NumPy arrays, tensors or sequences; ``scale`` comes
    back as a Python float holding its float32 value."""
    return (
        _tensor(segments, np.float32, torch.float32, device),
        _tensor(min_x, np.int32, torch.int32, device),
        _tensor(max_y, np.int32, torch.int32, device),
        float(np.float32(scale)),
    )


def grid_anchors(grids: Sequence[RasterGrid]) -> tuple[np.ndarray, np.ndarray, float]:
    """Per-glyph ``(min_x, max_y)`` anchors and the shared scale of a batch of
    grids (scale 1.0 for an empty batch)."""
    min_x = np.array([g.min_x for g in grids], np.int32)
    max_y = np.array([g.max_y for g in grids], np.int32)
    return min_x, max_y, grids[0].scale if grids else 1.0


def packed_to_device(batch: PackedBatch, grids: Sequence[RasterGrid], device):
    """A ``PackedBatch`` and its per-glyph grids as device tensors."""
    min_x, max_y, scale = grid_anchors(grids)
    return to_device(batch.segments, min_x, max_y, scale, device)


def triangles_to_device(tris, classes, grids: Sequence[RasterGrid], device):
    """Triangle meshes (float32 ``[B, M, 3, 4]``, class int32 ``[B, M]``) and
    their per-glyph grids as ``(tris, classes, min_x, max_y, scale)`` on
    ``device``: the inputs of ``kernels.loopblinn.loopblinn_batch``."""
    min_x, max_y, scale = grid_anchors(grids)
    return (
        _tensor(tris, np.float32, torch.float32, device),
        _tensor(classes, np.int32, torch.int32, device),
        _tensor(min_x, np.int32, torch.int32, device),
        _tensor(max_y, np.int32, torch.int32, device),
        float(np.float32(scale)),
    )
