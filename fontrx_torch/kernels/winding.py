"""The CUDA winding kernels (``csrc/winding.cu``) and their wrappers.

``winding()`` replaces the TPU's two winding kernels on the glyph fill path,
``winding_pallas_v2.py::_make_v2_kernel`` and
``winding_dense.py::_make_dense_kernel``; ``winding_windows()`` replaces the
window-packed one, ``winding_dense.py::_make_dense_win_kernel`` (K3). See the
note in the source.

A tensor on the CPU goes to the plain version, ``winding_ref``. A CUDA
tensor goes to the kernel, and a failed build or launch raises.
"""

from __future__ import annotations

import numpy as np
import torch

from fontrx_torch.kernels import _build, winding_ref

SOURCE = "fontrx_torch/csrc/winding.cu"

# launches of each kernel in this process; the wrappers add one per launch
launches = 0
windows_launches = 0


def _check(name, t, dtype, shape):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_inputs(segments, min_x, max_y, scale, height, width):
    """Check what the kernels take: float32 ``[B, S, 3, 2]`` segments and
    int32 ``[B]`` anchors, contiguous on one CUDA device, a finite
    ``scale > 0`` and a size >= 0. Returns ``(B, S, float32 scale)``."""
    if segments.dim() != 4 or segments.shape[2:] != (3, 2):
        raise ValueError(f"segments must be [B, S, 3, 2], got {tuple(segments.shape)}")
    b, s = segments.shape[:2]
    _check("segments", segments, torch.float32, (b, s, 3, 2))
    _check("min_x", min_x, torch.int32, (b,))
    _check("max_y", max_y, torch.int32, (b,))
    if min_x.device != segments.device or max_y.device != segments.device:
        raise ValueError("segments, min_x and max_y must be on one device")
    scale = np.float32(scale)
    if not (np.isfinite(scale) and scale > 0):
        raise ValueError(f"scale must be finite and > 0, got {scale}")
    if height < 0 or width < 0:
        raise ValueError(f"bad raster size {height}x{width}")
    return b, s, scale


def winding_batch(
    segments, min_x, max_y, scale, *, height, width, sample_offset=(0.0, 0.0)
):
    """Batched nonzero winding maps: int32 ``[B, height, width]``.

    ``segments`` float32 ``[B, S, 3, 2]``, ``min_x``/``max_y`` int32 ``[B]``
    on one device; ``scale`` (> 0) and ``sample_offset`` are host numbers,
    rounded to float32. Same arguments and result as
    ``winding_ref.winding_batch``.
    """
    if segments.device.type == "cpu":
        return winding_ref.winding_batch(
            segments, min_x, max_y, scale, height=height, width=width,
            sample_offset=sample_offset,
        )
    b, s, scale = check_inputs(segments, min_x, max_y, scale, height, width)
    return launch(segments, min_x, max_y, scale, b, s, height, width, sample_offset)


def launch(segments, min_x, max_y, scale, b, s, height, width, sample_offset=(0.0, 0.0)):
    """Launch the kernel on inputs that ``check_inputs`` has passed."""
    global launches
    ox, oy = (np.float32(v) for v in sample_offset)

    out = torch.empty((b, height, width), dtype=torch.int32, device=segments.device)
    if out.numel() == 0:
        return out
    lib = _build.load("winding")
    with torch.cuda.device(segments.device):
        stream = torch.cuda.current_stream(segments.device).cuda_stream
        err = lib.winding(
            segments.data_ptr(), min_x.data_ptr(), max_y.data_ptr(),
            float(scale), float(ox), float(oy),
            b, s, height, width, out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"winding kernel launch failed: cudaError_t {err}")
    launches += 1
    return out


def winding_windows_batch(
    segments_win, counts, min_x, max_y, scale, *, height, width, win_rows,
    sample_offset=(0.0, 0.0),
):
    """Winding maps from a window-major stream (``pack.windows``): int32
    ``[B, height, width]``, the function of K3.

    ``segments_win`` float32 ``[B, n_windows * cap, 3, 2]``, ``counts``
    int32 ``[B, n_windows]`` and the anchors int32 ``[B]`` on one device,
    with ``n_windows`` the windows of ``win_rows`` rows that cover
    ``height``. Same arguments and result as
    ``winding_ref.winding_windows_batch``.
    """
    if counts.dim() != 2 or counts.shape[0] != segments_win.shape[0]:
        raise ValueError(f"counts must be [B, n_windows] for {segments_win.shape[0]} glyphs, "
                         f"got {tuple(counts.shape)}")
    b, nw = counts.shape
    if win_rows < 1 or nw != max(-(-height // win_rows), 1):
        raise ValueError(f"{nw} windows of {win_rows} rows do not cover {height} rows")
    if segments_win.dim() != 4 or segments_win.shape[1] % nw:
        raise ValueError(f"segments_win must be [B, {nw} * cap, 3, 2], "
                         f"got {tuple(segments_win.shape)}")
    if segments_win.device.type == "cpu":
        return winding_ref.winding_windows_batch(
            segments_win, counts, min_x, max_y, scale, height=height, width=width,
            win_rows=win_rows, sample_offset=sample_offset,
        )
    b, s, scale = check_inputs(segments_win, min_x, max_y, scale, height, width)
    _check("counts", counts, torch.int32, (b, nw))
    if counts.device != segments_win.device:
        raise ValueError("segments_win and counts must be on one device")
    return launch_windows(segments_win, counts, min_x, max_y, scale, b, nw, s // nw,
                          win_rows, height, width, sample_offset)


def launch_windows(segments_win, counts, min_x, max_y, scale, b, nw, cap, win_rows,
                   height, width, sample_offset=(0.0, 0.0)):
    """Launch ``winding_windows()`` on inputs that ``winding_windows_batch``
    has passed."""
    global windows_launches
    ox, oy = (np.float32(v) for v in sample_offset)

    out = torch.empty((b, height, width), dtype=torch.int32, device=segments_win.device)
    if out.numel() == 0:
        return out
    lib = _build.load("winding")
    with torch.cuda.device(segments_win.device):
        stream = torch.cuda.current_stream(segments_win.device).cuda_stream
        err = lib.winding_windows(
            segments_win.data_ptr(), counts.data_ptr(), min_x.data_ptr(), max_y.data_ptr(),
            float(scale), float(ox), float(oy),
            b, nw, cap, win_rows, height, width, out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"winding_windows kernel launch failed: cudaError_t {err}")
    windows_launches += 1
    return out
