"""fontrx_torch's RasterEngine, atlas packer and converters against the JAX
package's, on the CPU.

The port's engine follows ``oracle.winding_at(contract=False)`` bit for bit.
Against ``fontrx.engine.raster.RasterEngine(backend="jnp")`` a pixel may
differ only where the oracle's two FMA modes disagree (XLA:CPU contracts the
x-polynomial; the port does not).
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from fontrx.engine.atlas import pack_charset as jax_pack_charset
from fontrx.engine.raster import RasterEngine as JaxEngine
from fontrx.font.font import Font as JaxFont
from fontrx.kernels import oracle
from fontrx.pack.segments import (
    glyph_segments,
    pack_glyphs_hybrid,
    pack_glyphs_split,
)
from fontrx_torch.convert import grid_anchors, packed_to_device, to_device
from fontrx_torch.engine.atlas import pack_charset
from fontrx_torch.engine.raster import RasterEngine
from fontrx_torch.font.font import Font
from fontrx_torch.kernels import winding, winding_ref
from fontrx_torch.kernels.grid import RasterGrid
from fontrx_torch.pack.segments import PackedBatch, pack_glyph, pack_glyphs

ROOT = pathlib.Path(__file__).resolve().parents[1]
FONT = ROOT / "fontrx_torch" / "data" / "DejaVuSans.ttf"
CJK = ROOT / "tests" / "data" / "cjktest.ttf"
TILE = 40
SIZE = 36


@pytest.fixture(scope="module")
def font():
    return Font.open(str(FONT))


@pytest.fixture(scope="module")
def jax_font():
    return JaxFont.open(str(FONT))


CHARS = "AQg@é&iW"  # a compound glyph (é) and a long one (@) among plain ones


@pytest.fixture(scope="module")
def glyphs(font):
    return [font.get_glyph(c)[0] for c in CHARS]


@pytest.fixture(scope="module")
def jax_glyphs(jax_font):
    """The same glyphs from the JAX package's font, for its packers that
    the port does not copy (split, hybrid)."""
    return [jax_font.get_glyph(c)[0] for c in CHARS]


@pytest.fixture
def engine():
    return RasterEngine(device="cpu")


def same_grids(grids, jax_grids):
    """The port's and the JAX package's grids agree field for field."""
    return [dataclasses.astuple(g) for g in grids] == [dataclasses.astuple(g) for g in jax_grids]


def differing_pixels(out, want, segments, xs, ys, limit=4):
    """Each differing pixel with its sample point and the segments that
    cross its row right of it, each with its contribution recomputed alone
    by the plain version and by the oracle, as exact hex floats: enough to
    replay the pixel."""
    lines = [f"torch threads {torch.get_num_threads()}"]
    seg = np.asarray(segments, np.float32)
    for r, c in np.argwhere(out != want)[:limit]:
        cx, cy = np.float32(xs[c]), np.float32(ys[r])
        port = winding_ref.winding_contrib(torch.from_numpy(seg), torch.tensor(cx),
                                           torch.tensor(cy)).numpy()
        ref = [int(oracle.winding_at(s[None], cx, cy, contract=False)) for s in seg]
        crossing = [(k, [float(v).hex() for v in seg[k].ravel()], int(port[k]), ref[k])
                    for k in range(len(seg)) if port[k] or ref[k]]
        lines.append(f"pixel ({r}, {c}) at ({float(cx).hex()}, {float(cy).hex()}): "
                     f"{out[r, c]} against the oracle's {want[r, c]}; segments "
                     f"(index, p0 p1 p2, plain alone, oracle alone): {crossing}")
    return "\n".join(lines)


def assert_oracle_exact(out, segments, grids):
    for i, g in enumerate(grids):
        xs, ys = g.sample_coords()
        want = oracle.winding_at(segments[i], xs[None, :], ys[:, None], contract=False)
        if not np.array_equal(out[i], want):
            pytest.fail(f"glyph {i}: {int((out[i] != want).sum())} pixels differ from the "
                        f"oracle\n" + differing_pixels(out[i], want, segments[i], xs, ys))


def assert_ties_only(port, other, segments, grids):
    for i, g in enumerate(grids):
        diff = np.asarray(port[i]) != np.asarray(other[i])
        if not diff.any():
            continue
        xs, ys = g.sample_coords()
        cx, cy = xs[None, :], ys[:, None]
        tie = (oracle.winding_at(segments[i], cx, cy, contract=True)
               != oracle.winding_at(segments[i], cx, cy, contract=False))
        assert not (diff & ~tie).any(), f"glyph {i}: non-tie pixels differ"


class TestRasterEngine:
    def test_winding_packed(self, engine, font, glyphs):
        batch = pack_glyphs(glyphs)
        upem = font.info.units_per_em
        out, grids = engine.winding_packed(batch, SIZE, upem, TILE)
        jout, jgrids = JaxEngine(backend="jnp").winding_packed(batch, SIZE, upem, TILE)
        assert same_grids(grids, jgrids)
        assert out.dtype == torch.int32 and tuple(out.shape) == (len(glyphs), TILE, TILE)
        assert_oracle_exact(out.numpy(), batch.segments, grids)
        assert_ties_only(out.numpy(), np.asarray(jout), batch.segments, grids)

    def test_winding_packed_with_an_inexact_torch_sqrt(self, engine, font, glyphs,
                                                       monkeypatch):
        """The plain version does not lean on ``torch.sqrt`` on the CPU: in
        some processes it returned values up to 3.2e-4 off on thousands of
        elements, enough to flip pixels against the oracle. A ``torch.sqrt``
        2^-12 off changes no pixel of this batch."""
        exact = torch.sqrt
        monkeypatch.setattr(torch, "sqrt", lambda x: exact(x) * (1 + 2.0**-12))
        batch = pack_glyphs(glyphs)
        out, grids = engine.winding_packed(batch, SIZE, font.info.units_per_em, TILE)
        assert_oracle_exact(out.numpy(), batch.segments, grids)

    def test_winding_glyph(self, engine, font):
        g, _ = font.get_glyph("R")
        p = pack_glyph(g)
        grid = RasterGrid.for_glyph_box(p.box, 80, font.info.units_per_em)
        out = engine.winding_glyph(p.segments, grid)
        assert tuple(out.shape) == (grid.height, grid.width)
        np.testing.assert_array_equal(
            out.numpy(), oracle.winding_map(p.segments, grid, contract=False))
        jout = JaxEngine(backend="jnp").winding_glyph(p.segments, grid)
        assert_ties_only(out[None].numpy(), np.asarray(jout)[None], p.segments[None], [grid])

    def test_winding_packed_banded(self, engine, font, glyphs, jax_glyphs):
        upem = font.info.units_per_em
        out, grids = engine.winding_packed_banded(glyphs, SIZE, upem, TILE)
        jout, jgrids = JaxEngine(backend="jnp").winding_packed_banded(
            jax_glyphs, SIZE, upem, TILE)
        assert same_grids(grids, jgrids)
        segs = pack_glyphs(glyphs, sort="x").segments
        assert_oracle_exact(out.numpy(), segs, grids)
        assert_ties_only(out.numpy(), np.asarray(jout), segs, grids)

    @pytest.mark.parametrize("capacity", [16, 32])
    def test_winding_split(self, engine, font, jax_glyphs, capacity):
        glyphs = jax_glyphs
        upem = font.info.units_per_em
        split = pack_glyphs_split(glyphs, capacity=capacity)
        assert len(split) > len(glyphs)  # some glyphs really span rows
        out, grids = engine.winding_split(split, SIZE, upem, TILE)
        jout, jgrids = JaxEngine(backend="jnp").winding_split(split, SIZE, upem, TILE)
        assert same_grids(grids, jgrids) and tuple(out.shape) == (len(glyphs), TILE, TILE)
        whole = [glyph_segments(g) for g in glyphs]
        for i, g in enumerate(grids):
            xs, ys = g.sample_coords()
            np.testing.assert_array_equal(
                out[i].numpy(),
                oracle.winding_at(whole[i], xs[None, :], ys[:, None], contract=False))
        jout = np.asarray(jout)
        for i, g in enumerate(grids):
            assert_ties_only(out[i : i + 1].numpy(), jout[i : i + 1], [whole[i]], [g])

    def test_winding_hybrid(self, engine, font, jax_glyphs):
        glyphs = jax_glyphs
        upem = font.info.units_per_em
        hb = pack_glyphs_hybrid(glyphs, capacity=24)
        assert len(hb.groups) > 1
        out, grids = engine.winding_hybrid(hb, SIZE, upem, TILE)
        jout, jgrids = JaxEngine(backend="jnp").winding_hybrid(hb, SIZE, upem, TILE)
        assert same_grids(grids, jgrids) and tuple(out.shape) == (len(glyphs), TILE, TILE)
        segs = [glyph_segments(glyphs[gi]) for gi in hb.order]
        assert_oracle_exact(out.numpy(), segs, grids)
        assert_ties_only(out.numpy(), np.asarray(jout), segs, grids)

    def test_winding_hybrid_empty(self, engine):
        out, grids = engine.winding_hybrid(pack_glyphs_hybrid([]), SIZE, 2048, TILE)
        assert tuple(out.shape) == (0, TILE, TILE) and grids == []

    @pytest.mark.parametrize("mode", ["fill", "gray"])
    def test_fill_gray_match_jax(self, mode):
        rng = np.random.default_rng(3)
        w = rng.integers(-9, 9, (3, 17, 19)).astype(np.int32)
        port = getattr(RasterEngine, mode)(torch.from_numpy(w))
        jax_out = getattr(JaxEngine, mode)(w)
        assert port.dtype == torch.uint8
        np.testing.assert_array_equal(port.numpy(), np.asarray(jax_out))

    def test_sample_offset(self, engine, font, glyphs):
        batch = pack_glyphs(glyphs[:3])
        grids = [RasterGrid.fixed_tile(tuple(b), SIZE, font.info.units_per_em, TILE)
                 for b in batch.boxes]
        off = (0.25, -0.25)
        out = engine.winding_batch(batch.segments, *grid_anchors(grids), height=TILE,
                                   width=TILE, sample_offset=off).numpy()
        f32 = np.float32
        for i, g in enumerate(grids):
            xs = ((g.min_x + np.arange(TILE)).astype(f32) + f32(off[0])) / f32(g.scale)
            ys = ((g.max_y - np.arange(TILE)).astype(f32) + f32(off[1])) / f32(g.scale)
            np.testing.assert_array_equal(
                out[i], oracle.winding_at(batch.segments[i], xs[None, :], ys[:, None],
                                          contract=False))

    def test_cpu_engine_never_launches(self, engine, glyphs, font):
        before = winding.launches
        engine.winding_packed(pack_glyphs(glyphs[:2]), SIZE, font.info.units_per_em, TILE)
        assert winding.launches == before

    def test_device_is_explicit(self):
        assert RasterEngine(device="cpu").device == torch.device("cpu")
        with pytest.raises(TypeError):
            RasterEngine()


class TestPackCharset:
    """The port has one packing path; it equals both of the reference's
    (native C++ and Python)."""

    @pytest.mark.parametrize("use_native", [True, False])
    @pytest.mark.parametrize("which", ["ascii", "latin", "cjk"])
    def test_equals_reference(self, use_native, which):
        path = CJK if which == "cjk" else FONT
        if which == "cjk":
            chars = [0x4E00 + i for i in range(0, 1024, 97)]
        else:
            chars = list(range(33, 127)) if which == "ascii" else "éàüÅß·ﬁ€"
        pad = None if which != "latin" else 12
        port = pack_charset(Font.open(path), chars, pad_batch_to=pad)
        ref = jax_pack_charset(JaxFont.open(str(path)), chars, pad_batch_to=pad,
                               use_native=use_native)
        assert isinstance(port, PackedBatch)
        for field in ("segments", "seg_counts", "boxes", "advance_widths"):
            a, b = getattr(port, field), getattr(ref, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)

    def test_native_equals_pure(self, font, jax_font):
        chars = "Hello, World! é"
        np.testing.assert_array_equal(
            pack_charset(font, chars).segments,
            jax_pack_charset(jax_font, chars, use_native=True).segments)


class TestConvert:
    def test_to_device_types(self):
        segs = np.ones((2, 3, 3, 2), np.float64)
        s, mx, my, scale = to_device(segs, [1, 2], np.array([3, 4]), 0.1, "cpu")
        assert s.dtype == torch.float32 and s.is_contiguous() and tuple(s.shape) == (2, 3, 3, 2)
        assert mx.dtype == torch.int32 and my.dtype == torch.int32
        assert mx.tolist() == [1, 2] and my.tolist() == [3, 4]
        assert scale == float(np.float32(0.1))

    def test_tensors_pass_through(self):
        t = torch.zeros((1, 2, 3, 2))
        s, mx, _, _ = to_device(t, torch.tensor([5]), torch.tensor([6]), 1.0, "cpu")
        assert s.data_ptr() == t.data_ptr() and mx.dtype == torch.int32

    def test_packed_to_device(self, font, glyphs):
        batch = pack_glyphs(glyphs[:3])
        grids = [RasterGrid.fixed_tile(tuple(b), SIZE, font.info.units_per_em, TILE)
                 for b in batch.boxes]
        s, mx, my, scale = packed_to_device(batch, grids, "cpu")
        np.testing.assert_array_equal(s.numpy(), batch.segments)
        assert mx.tolist() == [g.min_x for g in grids]
        assert my.tolist() == [g.max_y for g in grids]
        assert scale == grids[0].scale

    def test_grid_anchors_empty(self):
        mx, my, scale = grid_anchors([])
        assert mx.shape == (0,) and my.shape == (0,) and scale == 1.0
