"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` file exports plain C functions. It is compiled at
first use with ``nvcc`` into a shared library under ``build/fontrx_torch/``
at the root of the checkout, keyed by a hash of the flags, the source and
every ``csrc/*.cuh`` header, and loaded with ``ctypes``. No PyTorch header
is compiled, so a build takes seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "fontrx_torch"

# -fmad=false: no multiply-add contraction, so every product rounds on its own
#   as in the oracle's contract=False mode (the TPU rasters' mode).
# No --use_fast_math, -ftz=true, -prec-div=false or -prec-sqrt=false: '/' and
#   sqrtf stay correctly rounded and denormals are kept.
# sm_90a: the Hopper target (the plain sm_90 target lacks wgmma/setmaxnreg).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

# library -> the C functions it exports -> (restype, argtypes)
_SIGNATURES = {
    "winding": {
        "winding": (
            ctypes.c_int,
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # seg, min_x, max_y
             ctypes.c_float, ctypes.c_float, ctypes.c_float,      # scale, ox, oy
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, S, H, W
             ctypes.c_void_p, ctypes.c_void_p],                   # out, stream
        ),
        "winding_plan": (
            ctypes.c_int,
            [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H, W, win_rows
             ctypes.c_int, ctypes.c_void_p],                      # SMs, plan: int32 [4]
        ),
        "winding_windows": (
            ctypes.c_int,
            [ctypes.c_void_p, ctypes.c_void_p,                    # seg, counts
             ctypes.c_void_p, ctypes.c_void_p,                    # min_x, max_y
             ctypes.c_float, ctypes.c_float, ctypes.c_float,      # scale, ox, oy
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, nw, cap, win_rows
             ctypes.c_int, ctypes.c_int,                          # H, W
             ctypes.c_void_p, ctypes.c_void_p],                   # out, stream
        ),
        "winding_banded_plan": (
            ctypes.c_int,
            [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, S, R, W
             ctypes.c_int, ctypes.c_void_p],                      # SMs, plan: int32 [5]
        ),
        "winding_banded": (
            ctypes.c_int,
            [ctypes.c_void_p, ctypes.c_void_p,                    # seg, owners
             ctypes.c_void_p, ctypes.c_void_p,                    # min_x, max_y
             ctypes.c_float, ctypes.c_float, ctypes.c_float,      # scale, ox, oy
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, S, R, W
             ctypes.c_void_p, ctypes.c_void_p],                   # out, stream
        ),
    },
    "coverage": {"coverage": (
        ctypes.c_int,
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # seg, min_x, max_y
         ctypes.c_float, ctypes.c_float, ctypes.c_int,        # scale, inv_k2, k
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, S, H, W
         ctypes.c_void_p, ctypes.c_void_p],                   # out, stream
    ), "coverage_plan": (
        ctypes.c_int,
        [ctypes.c_int, ctypes.c_int, ctypes.c_int,            # k, H, W
         ctypes.c_void_p],                                    # plan: int32 [6]
    )},
    "sdf": {"sdf": (
        ctypes.c_int,
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # seg, min_x, max_y
         ctypes.c_void_p,                                     # winding
         ctypes.c_float, ctypes.c_float,                      # scale, spread
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, S, H, W
         ctypes.c_void_p, ctypes.c_void_p],                   # out, stream
    )},
    "loopblinn": {"loopblinn": (
        ctypes.c_int,
        [ctypes.c_void_p, ctypes.c_void_p,                    # tris, classes
         ctypes.c_void_p, ctypes.c_void_p,                    # min_x, max_y
         ctypes.c_float, ctypes.c_float, ctypes.c_float,      # scale, ox, oy
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, M, H, W
         ctypes.c_void_p, ctypes.c_void_p],                   # out, stream
    ), "loopblinn_plan": (
        ctypes.c_int,
        [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, M, H, W
         ctypes.c_int, ctypes.c_void_p],                      # SMs, plan: int32 [6]
    )},
    "roofline": {
        "roofline": (
            ctypes.c_int,
            [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,     # mix, x, out
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p],        # n, iters, stream
        ),
        "roofline_unroll": (ctypes.c_int, []),
    },
    "page": {
        "page": (
            ctypes.c_int,
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # seg, owner, offsets
             ctypes.c_int, ctypes.c_int, ctypes.c_float,          # S, N, s_px
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # top, out_h, W, mode
             ctypes.c_int, ctypes.c_int, ctypes.c_int,            # chunk, tile_w, x_cull
             ctypes.c_float, ctypes.c_float, ctypes.c_int,        # ox, oy, stride
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],  # scratch, out, stream
        ),
        "page_msaa": (
            ctypes.c_int,
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # seg, owner, offsets
             ctypes.c_int, ctypes.c_int, ctypes.c_float,          # S, N, s_px
             ctypes.c_int, ctypes.c_int,                          # H, W
             ctypes.c_int, ctypes.c_int, ctypes.c_int,            # chunk, tile_w, x_cull
             ctypes.c_float, ctypes.c_float,                      # ox0, ox1
             ctypes.c_float, ctypes.c_float, ctypes.c_int,        # oy0, oy1, stride
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],  # scratch, out, stream
        ),
    },
}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str | None:
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin``, then
    ``/usr/local/cuda/bin``, then ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc")


def library_path(name: str) -> pathlib.Path:
    """Where the library built from ``csrc/<name>.cu`` lives. The key
    covers every header in ``csrc/``, so a changed header never loads a
    library built from the old one."""
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    flags exists. Raises ``RuntimeError`` when there is no ``nvcc`` or it
    fails."""
    out = library_path(name)
    if out.exists():
        return out
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build if needed, load once, and declare the C signatures."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn_name, (restype, argtypes) in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.restype = restype
            fn.argtypes = argtypes
        _loaded[name] = lib
    return lib
