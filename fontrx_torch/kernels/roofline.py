"""The CUDA roofline microkernel (``csrc/roofline.cu``) and its wrapper.

The kernel replaces the TPU's saturating elementwise probe,
``tools/tpu_probes/tpu_roofline.py::_bench_elementwise`` (K13); see the note
in the source. A tensor on the CPU goes to the plain version,
``roofline_ref``. A CUDA tensor goes to the kernel, and a failed build or
launch raises.
"""

from __future__ import annotations

import torch

from fontrx_torch.kernels import _build, roofline_ref

SOURCE = "fontrx_torch/csrc/roofline.cu"
# the C entry's mix numbers, in roofline_ref.MIXES's order
MIX_IDS = {mix: i for i, mix in enumerate(roofline_ref.MIXES)}

# launches of the kernel in this process; the wrapper adds one per launch
launches = 0


def unroll() -> int:
    """The kernel's applications per loop trip (``kUnroll``): on the card,
    ``iters`` is a multiple of it."""
    return _build.load("roofline").roofline_unroll()


def elementwise(mix, x, iters) -> torch.Tensor:
    """``iters`` dependent applications of ``mix`` (a key of
    ``roofline_ref.MIXES``) to every element of ``x``, which has the mix's
    dtype; on the card ``iters`` is a multiple of ``unroll()``, else the
    launch fails. Same arguments and result as
    ``roofline_ref.elementwise``."""
    global launches
    if mix not in MIX_IDS:
        raise ValueError(f"unknown mix {mix!r}; expected one of {sorted(MIX_IDS)}")
    dtype = roofline_ref.MIXES[mix][0]
    if x.dtype != dtype:
        raise TypeError(f"{mix} takes {dtype}, got {x.dtype}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if x.device.type == "cpu":
        return roofline_ref.elementwise(mix, x, iters)
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA or CPU tensor, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.numel() > 2**31 - 256:
        raise ValueError(f"x has {x.numel()} elements, more than the kernel indexes")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = _build.load("roofline")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.roofline(MIX_IDS[mix], x.data_ptr(), out.data_ptr(), x.numel(), iters, stream)
    if err != 0:
        raise RuntimeError(f"roofline kernel launch failed: cudaError_t {err}")
    launches += 1
    return out
