"""The CUDA SDF kernel (``csrc/sdf.cu``) and its wrapper.

One kernel replaces the TPU's two SDF kernels, K10
(``sdf_pallas.py::_make_sdf_kernel``) and K11
(``sdf_pallas.py::_make_sdf_tiled_kernel``); see the note in the source.
It takes the sign from a winding map, so ``sdf_batch`` makes two launches,
as on the TPU: ``winding.winding_batch``, then the distance kernel.

A tensor on the CPU goes to the plain version, ``sdf_ref``. A CUDA tensor
goes to the kernels, and a failed build or launch raises.
"""

from __future__ import annotations

import numpy as np
import torch

from fontrx_torch.kernels import _build, sdf_ref, winding
from fontrx_torch.kernels.sdf_ref import SPREAD_PX

SOURCE = "fontrx_torch/csrc/sdf.cu"

# launches of the distance kernel in this process; the wrapper adds one per launch
launches = 0


def _check_spread(spread_px):
    spread = np.float32(spread_px)
    if not (np.isfinite(spread) and spread >= 0):
        raise ValueError(f"spread_px must be finite and >= 0, got {spread_px}")
    return spread


def _launch(segments, min_x, max_y, scale, winding_map, spread, b, s, height, width):
    """Launch the distance kernel on checked inputs."""
    global launches
    out = torch.empty((b, height, width), dtype=torch.float32, device=segments.device)
    if out.numel() == 0:
        return out
    lib = _build.load("sdf")
    with torch.cuda.device(segments.device):
        stream = torch.cuda.current_stream(segments.device).cuda_stream
        err = lib.sdf(
            segments.data_ptr(), min_x.data_ptr(), max_y.data_ptr(), winding_map.data_ptr(),
            float(scale), float(spread), b, s, height, width, out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"sdf kernel launch failed: cudaError_t {err}")
    launches += 1
    return out


def sdf_from_winding(segments, min_x, max_y, scale, winding_map, *, height, width,
                     spread_px=SPREAD_PX):
    """Signed distances in pixels, float32 ``[B, height, width]``, from the
    segments and their int32 ``[B, height, width]`` winding map: positive
    where the winding is not 0, clamped at ``+-spread_px``. Same arguments
    and result as ``sdf_ref.sdf_from_winding``."""
    if segments.device.type == "cpu":
        return sdf_ref.sdf_from_winding(
            segments, min_x, max_y, scale, winding_map, height=height, width=width,
            spread_px=spread_px)
    b, s, scale = winding.check_inputs(segments, min_x, max_y, scale, height, width)
    winding._check("winding_map", winding_map, torch.int32, (b, height, width))
    if winding_map.device != segments.device:
        raise ValueError("segments and winding_map must be on one device")
    spread = _check_spread(spread_px)
    return _launch(segments, min_x, max_y, scale, winding_map, spread, b, s, height, width)


def sdf_batch(segments, min_x, max_y, scale, *, height, width, spread_px=SPREAD_PX):
    """Batched signed distance fields: float32 ``[B, height, width]`` in
    pixels, positive inside, clamped at ``+-spread_px``.

    ``segments`` float32 ``[B, S, 3, 2]``, ``min_x``/``max_y`` int32 ``[B]``
    on one device; ``scale`` (> 0) is a host number, rounded to float32.
    Same arguments and result as ``sdf_ref.sdf_batch``.
    """
    if segments.device.type == "cpu":
        return sdf_ref.sdf_batch(segments, min_x, max_y, scale, height=height, width=width,
                                 spread_px=spread_px)
    b, s, scale = winding.check_inputs(segments, min_x, max_y, scale, height, width)
    spread = _check_spread(spread_px)
    w = winding.launch(segments, min_x, max_y, scale, b, s, height, width)
    return _launch(segments, min_x, max_y, scale, w, spread, b, s, height, width)


sdf_to_u8 = sdf_ref.sdf_to_u8
