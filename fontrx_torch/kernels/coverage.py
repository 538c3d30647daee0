"""The CUDA coverage kernel (``csrc/coverage.cu``) and its wrapper.

The kernel replaces the TPU's k x k coverage kernel (K9,
``coverage_pallas.py::_make_coverage_kernel``); see the note in the source.

A tensor on the CPU goes to the plain version, ``coverage_ref``. A CUDA
tensor goes to the kernel, and a failed build or launch raises.
"""

from __future__ import annotations

import torch

from fontrx_torch.kernels import _build, coverage_ref
from fontrx_torch.kernels.winding import check_inputs

SOURCE = "fontrx_torch/csrc/coverage.cu"

# launches of the kernel in this process; the wrapper adds one per launch
launches = 0


def coverage_batch(segments, min_x, max_y, scale, *, height, width, samples=2):
    """Batched k x k supersampled coverage, k = ``samples``: float32
    ``[B, height, width]`` in [0, 1].

    ``segments`` float32 ``[B, S, 3, 2]``, ``min_x``/``max_y`` int32 ``[B]``
    on one device; ``scale`` (> 0) is a host number, rounded to float32.
    Same arguments and result as ``coverage_ref.coverage_batch``.
    """
    if segments.device.type == "cpu":
        return coverage_ref.coverage_batch(
            segments, min_x, max_y, scale, height=height, width=width, samples=samples)
    global launches
    b, s, scale = check_inputs(segments, min_x, max_y, scale, height, width)
    if samples < 1:
        raise ValueError(f"samples must be >= 1, got {samples}")

    out = torch.empty((b, height, width), dtype=torch.float32, device=segments.device)
    if out.numel() == 0:
        return out
    lib = _build.load("coverage")
    with torch.cuda.device(segments.device):
        stream = torch.cuda.current_stream(segments.device).cuda_stream
        err = lib.coverage(
            segments.data_ptr(), min_x.data_ptr(), max_y.data_ptr(),
            float(scale), float(coverage_ref.inv_samples(samples)), samples,
            b, s, height, width, out.data_ptr(), stream,
        )
    if err != 0:
        # cudaErrorInvalidValue (1) also means that k x width needs more
        # shared memory than a block has
        raise RuntimeError(
            f"coverage kernel launch failed: cudaError_t {err} (k={samples}, width={width})")
    launches += 1
    return out

