"""The CUDA toolchain: what the kernels can be built with and run on."""

from __future__ import annotations

import subprocess

import torch

from fontrx_torch.kernels import _build


def probe() -> dict:
    """Torch and CUDA versions, the device and its compute capability
    (9.0 on an H100), the ``nvcc`` path and version, and whether ``triton``
    imports."""
    info: dict = {
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "device_count": torch.cuda.device_count() if torch.cuda.is_available() else 0,
    }
    if info["cuda_available"]:
        info["device"] = torch.cuda.get_device_name(0)
        info["capability"] = "%d.%d" % torch.cuda.get_device_capability(0)
    nvcc = _build.nvcc_path()
    info["nvcc"] = nvcc
    if nvcc is not None:
        proc = subprocess.run([nvcc, "--version"], capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if "release" in ln]
        info["nvcc_version"] = lines[-1].strip() if lines else proc.stdout.strip()
    try:
        import triton
    except ImportError:
        info["triton"] = None
    else:
        info["triton"] = triton.__version__
    return info


def require_cuda() -> torch.device:
    """The first CUDA device; raises ``RuntimeError`` when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)
