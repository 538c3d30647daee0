"""The glyph fill path end to end on the CPU: fontrx_torch against the JAX
package and the NumPy oracle, and chip_smoke.py's refusals off the card.

Against the JAX package a pixel may differ only where the oracle's two FMA
modes disagree (XLA:CPU contracts the x-polynomial; the port does not).
"""

import dataclasses
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__
from fontrx.engine.atlas import render_atlas as jax_render_atlas
from fontrx.engine.raster import RasterEngine as JaxEngine
from fontrx.font.font import Font as JaxFont
from fontrx.io import qoi as jax_qoi
from fontrx.kernels import oracle
from fontrx.kernels.grid import RasterGrid as JaxGrid
from fontrx.pack.segments import pack_glyph as jax_pack_glyph
from fontrx_torch.engine.atlas import AtlasLayout, pack_charset, render_atlas
from fontrx_torch.engine.raster import RasterEngine
from fontrx_torch.entry import _example_batch, entry
from fontrx_torch.font.font import Font
from fontrx_torch.io import qoi
from fontrx_torch.kernels.grid import RasterGrid
from fontrx_torch.pack.segments import pack_glyph

ROOT = pathlib.Path(__file__).resolve().parents[1]
FONT = ROOT / "fontrx_torch" / "data" / "DejaVuSans.ttf"
CJK = ROOT / "tests" / "data" / "cjktest.ttf"


@pytest.fixture(scope="module")
def font():
    return Font.open(str(FONT))


@pytest.fixture(scope="module")
def jax_font():
    return JaxFont.open(str(FONT))


def tie_mask(segments, cx, cy):
    return (oracle.winding_at(segments, cx, cy, contract=True)
            != oracle.winding_at(segments, cx, cy, contract=False))


def test_vendored_font_is_dejavu_sans(font):
    assert font.info.units_per_em == 2048
    assert (FONT.parent / "DejaVuSans-LICENSE.txt").read_text().count("Bitstream") > 0


@pytest.mark.parametrize("chars,size", [("fontrx!", 40), ("Wg@é", 72)])
def test_render_atlas_matches_jax(font, jax_font, chars, size):
    sheet, layout = render_atlas(font, chars, size, size, RasterEngine(device="cpu"))
    jsheet, jlayout = jax_render_atlas(jax_font, chars, size, size, JaxEngine(backend="jnp"))
    assert isinstance(layout, AtlasLayout)
    assert dataclasses.astuple(layout) == dataclasses.astuple(jlayout)
    assert sheet.dtype == np.uint8 and sheet.shape == jsheet.shape
    batch = pack_charset(font, chars)
    for i in range(len(chars)):
        x0, y0 = layout.tile_origin(i)
        tile = sheet[y0 : y0 + size, x0 : x0 + size]
        g = RasterGrid.fixed_tile(tuple(batch.boxes[i]), size, font.info.units_per_em, size)
        xs, ys = g.sample_coords()
        cx, cy = xs[None, :], ys[:, None]
        want = oracle.winding_at(batch.segments[i], cx, cy, contract=False) != 0
        np.testing.assert_array_equal(tile, np.where(want, 255, 0))
        diff = tile != jsheet[y0 : y0 + size, x0 : x0 + size]
        assert not (diff & ~tie_mask(batch.segments[i], cx, cy)).any()


def test_cjk_atlas_matches_jax():
    """The <= 128 px route (K2's on the TPU) on a few dense CJK glyphs."""
    f = Font.open(CJK)
    chars = [0x4E00 + i for i in (0, 311, 777)]
    batch = pack_charset(f, chars)
    assert batch.segments.shape[1] >= 192
    upem = f.info.units_per_em
    out, grids = RasterEngine(device="cpu").winding_packed(batch, 32, upem, 32)
    jout, _ = JaxEngine(backend="jnp").winding_packed(batch, 32, upem, 32)
    jout = np.asarray(jout)
    for i, g in enumerate(grids):
        xs, ys = g.sample_coords()
        cx, cy = xs[None, :], ys[:, None]
        np.testing.assert_array_equal(
            out[i].numpy(), oracle.winding_at(batch.segments[i], cx, cy, contract=False))
        diff = out[i].numpy() != jout[i]
        assert not (diff & ~tie_mask(batch.segments[i], cx, cy)).any()


def quick_start(engine, font, pack_glyph, grid_type, qoi):
    """The README quick start, with one package's front end."""
    glyph, _advance = font.get_glyph("A")
    packed = pack_glyph(glyph)
    grid = grid_type.for_glyph_box(packed.box, 96, font.info.units_per_em)
    fill = np.asarray(engine.fill(engine.winding_glyph(packed.segments, grid)))
    return qoi.encode_rgb(np.repeat(fill[:, :, None], 3, axis=2)), packed, grid


def test_quick_start_qoi(font, jax_font):
    data, packed, grid = quick_start(RasterEngine(device="cpu"), font, pack_glyph,
                                     RasterGrid, qoi)
    decoded = qoi.decode(data)
    want = np.where(oracle.winding_map(packed.segments, grid, contract=False) != 0, 255, 0)
    assert decoded.shape == (grid.height, grid.width, 3)
    for c in range(3):
        np.testing.assert_array_equal(decoded[:, :, c], want)

    jdata, _, _ = quick_start(JaxEngine(backend="jnp"), jax_font, jax_pack_glyph, JaxGrid,
                              jax_qoi)
    diff = (jax_qoi.decode(jdata) != decoded).any(axis=2)
    xs, ys = grid.sample_coords()
    assert not (diff & ~tie_mask(packed.segments, xs[None, :], ys[:, None])).any()


def test_entry_matches_graft_entry():
    fn, args = entry(device="cpu")
    jfn, jargs = __graft_entry__.entry()
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(_example_batch(), __graft_entry__._example_batch()):
        np.testing.assert_array_equal(a, b)
    out = fn(*args)
    assert out.dtype == torch.float32 and tuple(out.shape) == (8, 128, 640)
    assert bool(torch.isfinite(out).all()) and float(out.sum()) > 0
    jout = np.asarray(jfn(*jargs))
    segs, min_x, max_y, scale = jargs
    for i in range(0, len(segs), 3):
        grid = RasterGrid(640, 128, int(min_x[i]), int(max_y[i]), float(scale))
        xs, ys = grid.sample_coords()
        cx, cy = xs[None, :], ys[:, None]
        want = oracle.winding_at(segs[i], cx, cy, contract=False) != 0
        np.testing.assert_array_equal(out[i].numpy(), want.astype(np.float32))
        diff = out[i].numpy() != jout[i]
        assert not (diff & ~tie_mask(segs[i], cx, cy)).any()


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
