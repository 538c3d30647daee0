"""fontrx_torch winding kernels: the plain PyTorch version against the NumPy
oracle and the JAX package's kernels, the CUDA wrapper's CPU route, and the
CUDA kernel against the plain version on the card.

Exactness rules:
- ``winding_ref`` equals ``oracle.winding_at(contract=False)`` bit for bit.
- Against the JAX package on the CPU (``winding_jnp``, and the Pallas
  kernels in interpret mode) a pixel may differ only where the oracle's two
  FMA modes disagree: XLA:CPU contracts the x-polynomial, the port does not.

The module imports JAX only inside the tests that compare with it, so the
card's tests also run where there is no JAX:
``python -m pytest --noconftest -m requires_cuda tests/test_torch_winding.py``.
"""

import pathlib

import numpy as np
import pytest
import torch

from benchmarks.cjk import UPEM, synthetic_strokes
from fontrx.kernels import oracle
from fontrx_torch.font.font import Font
from fontrx_torch.kernels import winding, winding_ref
from fontrx_torch.kernels.grid import RasterGrid
from fontrx_torch.pack.segments import glyph_segments, pack_glyphs

FONT = pathlib.Path(__file__).resolve().parents[1] / "fontrx_torch" / "data" / "DejaVuSans.ttf"


@pytest.fixture(scope="module")
def font():
    return Font.open(FONT)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def coords(min_x, max_y, scale, h, w, offset=(0.0, 0.0)):
    """Oracle sample coordinates with the kernels' op order: int add, then
    the offset, then one f32 divide."""
    f32 = np.float32
    xs = ((min_x + np.arange(w)).astype(f32) + f32(offset[0])) / f32(scale)
    ys = ((max_y - np.arange(h)).astype(f32) + f32(offset[1])) / f32(scale)
    return xs[None, :], ys[:, None]


def ref(segments, min_x, max_y, scale, h, w, offset=(0.0, 0.0)):
    return winding_ref.winding_batch(
        torch.from_numpy(np.asarray(segments, np.float32)),
        torch.from_numpy(np.asarray(min_x, np.int32)),
        torch.from_numpy(np.asarray(max_y, np.int32)),
        float(scale), height=h, width=w, sample_offset=offset,
    ).numpy()


def assert_ties_only(port, other, segments, min_x, max_y, scale, h, w):
    """Every pixel where ``port`` and ``other`` differ is one where the
    oracle's contract=True and contract=False modes disagree."""
    for i in range(len(segments)):
        diff = port[i] != other[i]
        if not diff.any():
            continue
        cx, cy = coords(min_x[i], max_y[i], scale, h, w)
        tie = (oracle.winding_at(segments[i], cx, cy, contract=True)
               != oracle.winding_at(segments[i], cx, cy, contract=False))
        assert not (diff & ~tie).any(), f"glyph {i}: {int((diff & ~tie).sum())} non-tie pixels"


def glyph_batch(font, chars, size, tile):
    batch = pack_glyphs([font.get_glyph(c)[0] for c in chars])
    grids = [RasterGrid.fixed_tile(tuple(b), size, font.info.units_per_em, tile)
             for b in batch.boxes]
    min_x = np.array([g.min_x for g in grids], np.int32)
    max_y = np.array([g.max_y for g in grids], np.int32)
    return batch.segments, min_x, max_y, np.float32(grids[0].scale)


def synthetic_batch(size):
    rng = np.random.default_rng(5)
    segs = np.stack([synthetic_strokes(rng, 300) for _ in range(2)])
    return segs, np.zeros(2, np.int32), np.full(2, size - 1, np.int32), np.float32(size / UPEM)


class TestRefVsOracle:
    @pytest.mark.parametrize("ch", list("AQg@&"))
    def test_glyph_bitexact(self, font, ch):
        g, _ = font.get_glyph(ch)
        segs = glyph_segments(g)
        grid = RasterGrid.for_glyph_box(
            (g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max), 96,
            font.info.units_per_em)
        out = ref(segs[None], [grid.min_x], [grid.max_y], grid.scale, grid.height, grid.width)
        np.testing.assert_array_equal(
            out[0], oracle.winding_map(segs, grid, contract=False))

    @pytest.mark.parametrize("offset", [(0.25, -0.375), (-0.5, 0.5), (0.125, 0.0)])
    def test_sample_offset_bitexact(self, font, offset):
        segs, min_x, max_y, scale = glyph_batch(font, "B8%", 48, 48)
        out = ref(segs, min_x, max_y, scale, 48, 48, offset)
        for i in range(len(segs)):
            cx, cy = coords(min_x[i], max_y[i], scale, 48, 48, offset)
            np.testing.assert_array_equal(
                out[i], oracle.winding_at(segs[i], cx, cy, contract=False))

    def test_synthetic_300seg_bitexact(self):
        segs, min_x, max_y, scale = synthetic_batch(96)
        out = ref(segs, min_x, max_y, scale, 96, 96)
        for i in range(2):
            cx, cy = coords(min_x[i], max_y[i], scale, 96, 96)
            np.testing.assert_array_equal(
                out[i], oracle.winding_at(segs[i], cx, cy, contract=False))

    def test_chunking_is_exact(self, monkeypatch):
        segs, min_x, max_y, scale = synthetic_batch(48)
        whole = ref(segs, min_x, max_y, scale, 48, 40)
        # one segment per chunk, and a ragged last chunk
        monkeypatch.setattr(winding_ref, "_CHUNK_BUDGET", 2 * 48 * 40 * 16 * 7)
        assert winding_ref.seg_chunk(2, 48, 40) == 7
        np.testing.assert_array_equal(ref(segs, min_x, max_y, scale, 48, 40), whole)

    def test_zero_padding_is_inert(self, font):
        segs, min_x, max_y, scale = glyph_batch(font, "ag", 40, 40)
        padded = np.concatenate([segs, np.zeros_like(segs)], axis=1)
        np.testing.assert_array_equal(
            ref(padded, min_x, max_y, scale, 40, 40), ref(segs, min_x, max_y, scale, 40, 40))

    @pytest.mark.parametrize("start", [0.0, 2.0**-12, 1.0, 3.0e4, 2.0**40])
    def test_sqrt_rn_is_correctly_rounded(self, start):
        # 2^22 consecutive float32 values: NumPy's sqrt rounds to nearest
        first = int(np.float32(start).view(np.int32))
        x = np.arange(first, first + (1 << 22), dtype=np.int32).view(np.float32)
        np.testing.assert_array_equal(
            winding_ref.sqrt_rn(torch.from_numpy(x)).numpy(), np.sqrt(x))

    def test_sqrt_rn_does_not_use_torch_sqrt_on_the_cpu(self, monkeypatch):
        # torch.sqrt on the CPU is not correctly rounded, and some processes
        # saw it 3.2e-4 off: sqrt_rn must not depend on it there
        monkeypatch.setattr(torch, "sqrt", lambda x: x * 0)
        x = np.random.default_rng(0).random(1 << 16).astype(np.float32) * 2e5
        np.testing.assert_array_equal(
            winding_ref.sqrt_rn(torch.from_numpy(x)).numpy(), np.sqrt(x))

    def test_chunk_budget_bounds_peak_memory(self):
        # 94 glyphs at 256 x 256: one chunk's temporaries stay near 1 GiB
        step = winding_ref.seg_chunk(94, 256, 256)
        assert 1 <= step
        assert step * 94 * 256 * 256 * winding_ref._BYTES_PER_ELEMENT <= 1 << 30


class TestRefVsJax:
    def test_vs_winding_jnp(self, font):
        import jax.numpy as jnp

        from fontrx.kernels.winding_jnp import winding_batch

        for segs, min_x, max_y, scale in (
            glyph_batch(font, "AQg@", 64, 64), synthetic_batch(64),
        ):
            jax_out = np.asarray(winding_batch(
                jnp.asarray(segs), jnp.asarray(min_x), jnp.asarray(max_y),
                jnp.float32(scale), height=64, width=64))
            port = ref(segs, min_x, max_y, scale, 64, 64)
            assert_ties_only(port, jax_out, segs, min_x, max_y, scale, 64, 64)

    def test_vs_pallas_v2_interpret(self, font):
        """K1, the >128 px route, run as the JAX package's tests run it."""
        import jax.numpy as jnp

        from fontrx.kernels.winding_pallas_v2 import winding_pallas_v2_batch

        segs, min_x, max_y, scale = glyph_batch(font, "Qg&", 110, 128)
        jax_out = np.asarray(winding_pallas_v2_batch(
            jnp.asarray(segs), jnp.asarray(min_x), jnp.asarray(max_y),
            jnp.float32(scale), height=128, width=128, interpret=True, exact=True))
        port = ref(segs, min_x, max_y, scale, 128, 128)
        assert_ties_only(port, jax_out, segs, min_x, max_y, scale, 128, 128)

    def test_vs_dense_interpret(self):
        """K2, the <=128 px route, on the two 300-segment glyphs."""
        import jax.numpy as jnp

        from fontrx.kernels.winding_dense import winding_dense_batch

        segs, min_x, max_y, scale = synthetic_batch(32)
        jax_out = np.asarray(winding_dense_batch(
            jnp.asarray(segs), jnp.asarray(min_x), jnp.asarray(max_y),
            jnp.float32(scale), height=32, width=32, interpret=True, exact=True))
        port = ref(segs, min_x, max_y, scale, 32, 32)
        assert_ties_only(port, jax_out[:, :32, :32], segs, min_x, max_y, scale, 32, 32)


class TestWrapper:
    def test_cpu_tensor_runs_plain_version(self, font):
        segs, min_x, max_y, scale = glyph_batch(font, "Rx", 40, 48)
        before = winding.launches
        out = winding.winding_batch(
            torch.from_numpy(segs), torch.from_numpy(min_x), torch.from_numpy(max_y),
            float(scale), height=48, width=48)
        assert winding.launches == before
        assert out.dtype == torch.int32 and out.device.type == "cpu"
        np.testing.assert_array_equal(out.numpy(), ref(segs, min_x, max_y, scale, 48, 48))

    def test_check_rejects_what_the_kernel_does_not_take(self):
        t = torch.zeros((2, 4, 3, 2))
        with pytest.raises(ValueError, match="CUDA"):
            winding._check("segments", t, torch.float32, (2, 4, 3, 2))


@pytest.mark.requires_cuda
class TestKernelOnCard:
    @pytest.mark.parametrize("size,tile,offset", [
        (256, 256, (0.0, 0.0)), (64, 64, (0.0, 0.0)), (48, 40, (0.25, -0.375)),
    ])
    def test_kernel_matches_ref(self, cuda, font, size, tile, offset):
        for segs, min_x, max_y, scale in (
            glyph_batch(font, "AQg@&%Wb", size, tile), synthetic_batch(tile),
        ):
            args = (torch.from_numpy(segs).to(cuda), torch.from_numpy(min_x).to(cuda),
                    torch.from_numpy(max_y).to(cuda), float(scale))
            before = winding.launches
            out = winding.winding_batch(*args, height=tile, width=tile, sample_offset=offset)
            torch.cuda.synchronize()
            assert winding.launches == before + 1
            want = winding_ref.winding_batch(*args, height=tile, width=tile,
                                             sample_offset=offset)
            assert torch.equal(out, want)

    def test_kernel_matches_oracle(self, cuda, font):
        segs, min_x, max_y, scale = glyph_batch(font, "Q&", 128, 128)
        out = winding.winding_batch(
            torch.from_numpy(segs).to(cuda), torch.from_numpy(min_x).to(cuda),
            torch.from_numpy(max_y).to(cuda), float(scale), height=128, width=128,
        ).cpu().numpy()
        for i in range(len(segs)):
            cx, cy = coords(min_x[i], max_y[i], scale, 128, 128)
            np.testing.assert_array_equal(
                out[i], oracle.winding_at(segs[i], cx, cy, contract=False))

    def test_wrapper_rejects_bad_inputs(self, cuda):
        segs = torch.zeros((2, 4, 3, 2), device=cuda)
        anchors = torch.zeros(2, dtype=torch.int32, device=cuda)
        with pytest.raises(TypeError):
            winding.winding_batch(segs.double(), anchors, anchors, 1.0, height=8, width=8)
        with pytest.raises(ValueError):
            winding.winding_batch(segs, anchors[:1], anchors, 1.0, height=8, width=8)
        with pytest.raises(ValueError):
            winding.winding_batch(segs, anchors, anchors, 0.0, height=8, width=8)
        with pytest.raises(ValueError):
            winding.winding_batch(segs.transpose(0, 1).contiguous().transpose(0, 1),
                                  anchors, anchors, 1.0, height=8, width=8)
