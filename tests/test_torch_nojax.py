"""fontrx_torch and chip_smoke.py import neither JAX nor anything of the JAX
package ``fontrx`` or of its ``benchmarks``, and the CUDA build keeps the
float rules: no FMA contraction, no fast math, the Hopper target."""

import pathlib
import subprocess
import sys

import pytest
import torch

from fontrx_torch import device
from fontrx_torch.kernels import _build

ROOT = pathlib.Path(__file__).resolve().parents[1]

MODULES = [
    "fontrx_torch",
    "fontrx_torch.device",
    "fontrx_torch.bound",
    "fontrx_torch.convert",
    "fontrx_torch.entry",
    "fontrx_torch.kernels._build",
    "fontrx_torch.kernels.winding",
    "fontrx_torch.kernels.winding_ref",
    "fontrx_torch.kernels.coverage",
    "fontrx_torch.kernels.coverage_ref",
    "fontrx_torch.kernels.sdf",
    "fontrx_torch.kernels.sdf_ref",
    "fontrx_torch.kernels.loopblinn",
    "fontrx_torch.kernels.loopblinn_ref",
    "fontrx_torch.kernels.page",
    "fontrx_torch.kernels.page_ref",
    "fontrx_torch.kernels.grid",
    "fontrx_torch.kernels.oracle",
    "fontrx_torch.font",
    "fontrx_torch.font.reader",
    "fontrx_torch.font.ttf",
    "fontrx_torch.font.charmap",
    "fontrx_torch.font.glyph",
    "fontrx_torch.font.font",
    "fontrx_torch.geometry",
    "fontrx_torch.geometry.triangulate",
    "fontrx_torch.geometry.triangulated_glyph",
    "fontrx_torch.pack",
    "fontrx_torch.pack.segments",
    "fontrx_torch.pack.windows",
    "fontrx_torch.bench",
    "fontrx_torch.bench.cjk",
    "fontrx_torch.io",
    "fontrx_torch.io.qoi",
    "fontrx_torch.engine.raster",
    "fontrx_torch.engine.atlas",
    "fontrx_torch.scene",
    "fontrx_torch.scene.transform",
    "fontrx_torch.scene.layout",
    "fontrx_torch.scene.page",
    "fontrx_torch.scene.interactive",
    "chip_smoke",
]


@pytest.mark.parametrize("module", MODULES)
def test_imports_without_jax(module):
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')"
        " and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
        "ref = sorted(m for m in sys.modules if m.split('.')[0] in ('fontrx', 'benchmarks'))\n"
        "assert not ref, ref\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_nvcc_flags_keep_float_rules():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "-fmad=false" in flags
    assert "sm_90a" in flags and "compute_90a" in flags
    for bad in ("--use_fast_math", "-use_fast_math", "-ftz=true", "-prec-div=false",
                "-prec-sqrt=false", "-fmad=true"):
        assert bad not in flags


@pytest.mark.parametrize("source", ["winding.cu", "coverage.cu", "crossings.cuh", "sdf.cu",
                                    "loopblinn.cu", "page.cu"])
def test_source_uses_no_fast_intrinsics(source):
    src = (_build.CSRC_DIR / source).read_text()
    for bad in ("__fdividef", "__fsqrt_rn", "__fmaf", "fmaf(", "rsqrtf", "__expf"):
        assert bad not in src


def test_library_is_keyed_by_source(tmp_path, monkeypatch):
    (tmp_path / "winding.cu").write_text("// a\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build.library_path("winding")
    (tmp_path / "winding.cu").write_text("// b\n")
    second = _build.library_path("winding")
    assert first != second and first.parent == _build.BUILD_DIR
    assert _build.BUILD_DIR == ROOT / "build" / "fontrx_torch"


def test_library_is_keyed_by_headers(tmp_path, monkeypatch):
    (tmp_path / "coverage.cu").write_text('#include "crossings.cuh"\n')
    (tmp_path / "crossings.cuh").write_text("// a\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build.library_path("coverage")
    (tmp_path / "crossings.cuh").write_text("// b\n")
    assert _build.library_path("coverage") != first


def test_every_kernel_has_a_source_and_signature():
    sources = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    assert sources == sorted(_build._SIGNATURES)


def test_port_loads_no_library_of_the_jax_package():
    for path in [*(ROOT / "fontrx_torch").rglob("*.py"), ROOT / "chip_smoke.py"]:
        text = path.read_text()
        assert "libfontrx_native" not in text and "fontrx/native" not in text, path


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    (tmp_path / "winding.cu").write_text("// not built here\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("winding")
    assert not (tmp_path / "build").exists()


def test_probe_reports_toolchain():
    info = device.probe()
    for key in ("torch", "torch_cuda", "cuda_available", "device_count", "nvcc", "triton"):
        assert key in info
    assert info["cuda_available"] == torch.cuda.is_available()


def test_require_cuda():
    if torch.cuda.is_available():
        assert device.require_cuda().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device.require_cuda()
