"""fontrx_torch SDF atlas: the plain PyTorch version against the JAX
package's two TPU kernels (K10 flat and K11 tiled, run in interpret mode),
its jnp fallback (the sdf32 gate family) and its engine; the kernel's tile
cull; the wrapper's CPU route; and the CUDA kernel against the plain version
on the card.

Tolerances and their reasons:
- against the JAX package on the CPU, distances agree within 1e-4 px (the
  bound of the package's own flat-vs-scalar test): XLA:CPU contracts and
  fuses the Newton program, the port rounds every operation on its own, so
  pixels differ by an ulp or two;
- signs agree except where the oracle's contract=True and contract=False
  windings disagree (a tie pixel: XLA:CPU contracts the winding's
  x-polynomial, the port does not);
- against the jnp fallback (8 starts x 4 iterations), within the 8-bit
  quantization step 8/127 px, as ``benchmarks/full_gate.py`` gates it;
- the kernel's cull, and the kernel on the card, bit for bit.

The module imports JAX only inside the tests that compare with it, so the
card's tests also run where there is no JAX:
``python -m pytest --noconftest -m requires_cuda tests/test_torch_sdf.py``.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from fontrx_torch import bound
from fontrx_torch.engine.raster import RasterEngine
from fontrx_torch.font.font import Font
from fontrx_torch.kernels import _build, oracle, sdf, sdf_ref, winding, winding_ref
from fontrx_torch.kernels.grid import RasterGrid
from fontrx_torch.pack.segments import pack_glyphs

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEJAVU = ROOT / "fontrx_torch" / "data" / "DejaVuSans.ttf"
CJK = ROOT / "tests" / "data" / "cjktest.ttf"
CJK_CHARS = [chr(0x4E00 + i) for i in (0, 87, 301, 777)]
TOL = 1e-4
f32 = np.float32
# the boxes of pixels the cull is held conservative at: K11's 16 x 16 tile
# (its host pack's lists) and the box a pixel slot of a warp culls for
BOXES = [pytest.param((16, 16), id="tile16x16"),
         pytest.param(bound.SDF_CULL_BOX, id="slot{}x{}".format(*bound.SDF_CULL_BOX))]


@pytest.fixture(scope="module")
def dejavu():
    return Font.open(DEJAVU)


@pytest.fixture(scope="module")
def cjk():
    return Font.open(CJK)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def one_torch_thread():
    """Small images: torch on one thread, so parallel test workers do not
    spin against each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_batch(size, b=3, n=96):
    """The JAX package's SDF test batch (``tests/test_kernels.py:738-746``):
    ``n`` (96) random quadratics a glyph, the last 5 rows all zero,
    ``min_x = 3``."""
    rng = np.random.default_rng(1234)
    p0 = rng.uniform(100, 1900, (b, n, 2))
    p1 = p0 + rng.uniform(-80, 80, (b, n, 2))
    p2 = p0 + rng.uniform(-80, 80, (b, n, 2))
    seg = np.stack([p0, p1, p2], 2).astype(f32)
    seg[:, -5:] = 0.0
    return seg, np.full(b, 3, np.int32), np.full(b, size - 1, np.int32), f32(size / 2048)


def glyph_batch(font, chars, size, tile):
    batch = pack_glyphs([font.get_glyph(c)[0] for c in chars])
    grids = [RasterGrid.fixed_tile(tuple(b), size, font.info.units_per_em, tile)
             for b in batch.boxes]
    min_x = np.array([g.min_x for g in grids], np.int32)
    max_y = np.array([g.max_y for g in grids], np.int32)
    return batch.segments, min_x, max_y, f32(grids[0].scale)


def tensors(segs, min_x, max_y, scale, device="cpu"):
    return (torch.from_numpy(np.ascontiguousarray(segs, f32)).to(device),
            torch.from_numpy(np.asarray(min_x, np.int32)).to(device),
            torch.from_numpy(np.asarray(max_y, np.int32)).to(device), float(scale))


def port_sdf(batch, h, w, **kw):
    return sdf_ref.sdf_batch(*tensors(*batch), height=h, width=w, **kw).numpy()


def jax_args(batch):
    import jax.numpy as jnp

    segs, min_x, max_y, scale = batch
    return jnp.asarray(segs), jnp.asarray(min_x), jnp.asarray(max_y), jnp.float32(scale)


def inside_oracle(seg, min_x, max_y, scale, h, w, contract):
    xs = (min_x + np.arange(w)).astype(f32) / f32(scale)
    ys = (max_y - np.arange(h)).astype(f32) / f32(scale)
    return oracle.winding_at(seg, xs[None, :], ys[:, None], contract=contract) != 0


def assert_close(port, other, batch, h, w):
    """Distances within ``TOL`` px; signs equal but at oracle tie pixels; the
    port's sign is the oracle's (contract=False) everywhere."""
    segs, min_x, max_y, scale = batch
    other = np.asarray(other)
    assert port.shape == other.shape == (len(segs), h, w) and port.dtype == f32
    np.testing.assert_allclose(np.abs(port), np.abs(other), rtol=0, atol=TOL)
    for i in range(len(segs)):
        strict = inside_oracle(segs[i], min_x[i], max_y[i], scale, h, w, False)
        np.testing.assert_array_equal(~np.signbit(port[i]), strict)
        tie = strict != inside_oracle(segs[i], min_x[i], max_y[i], scale, h, w, True)
        differ = np.signbit(port[i]) != np.signbit(other[i])
        assert not (differ & ~tie).any(), f"glyph {i}: signs differ off the ties"


class TestRefVsJax:
    @pytest.mark.parametrize("size", [32, 64])
    def test_vs_flat_kernel(self, size):
        """K10 (``sdf_pallas_batch``, flat mode) on its own test batch."""
        from fontrx.kernels.sdf_pallas import sdf_pallas_batch

        batch = random_batch(size)
        want = sdf_pallas_batch(*jax_args(batch), height=size, width=size, flat=True,
                                interpret=True)
        port = port_sdf(batch, size, size)
        assert_close(port, want, batch, size, size)
        assert (np.abs(port) < 8).any() and (np.abs(port) == 8).any()  # band and far field

    @pytest.mark.parametrize("tile_h,tile_w", [(8, 16), (16, 16)])
    def test_vs_tiled_kernel(self, tile_h, tile_w):
        """K11 (``sdf_pallas_tiled_batch``) from ``pack_sdf_tiles``."""
        from fontrx.kernels.sdf_pallas import pack_sdf_tiles, sdf_pallas_tiled_batch

        batch = random_batch(64)
        segs, min_x, max_y, scale = batch
        stream, cnts, tids, cap = pack_sdf_tiles(segs, min_x, max_y, scale, 64, 64,
                                                 tile_h=tile_h, tile_w=tile_w)
        want = sdf_pallas_tiled_batch(
            *jax_args(batch)[:1], stream, cnts, tids, *jax_args(batch)[1:], height=64,
            width=64, cap=cap, tile_h=tile_h, tile_w=tile_w, interpret=True)
        assert_close(port_sdf(batch, 64, 64), want, batch, 64, 64)

    @pytest.mark.parametrize("which,size", [("dejavu", 32), ("dejavu", 64), ("cjk", 32),
                                            ("cjk", 64)])
    def test_glyphs_vs_flat_kernel(self, dejavu, cjk, which, size):
        from fontrx.kernels.sdf_pallas import sdf_pallas_batch

        batch = (glyph_batch(dejavu, "Wé8", size, size) if which == "dejavu"
                 else glyph_batch(cjk, CJK_CHARS, size, size))
        want = sdf_pallas_batch(*jax_args(batch), height=size, width=size, flat=True,
                                interpret=True)
        assert_close(port_sdf(batch, size, size), want, batch, size, size)

    @pytest.mark.parametrize("which", ["dejavu", "cjk"])
    def test_non_square_vs_padded_route(self, dejavu, cjk, which):
        """A 36 x 52 grid against the JAX engine's route for grids that flat
        mode refuses: the launcher at ``width=128``, cropped. Its height
        must be a multiple of 8, so it runs 40 rows; a pixel's value does
        not depend on the raster's size."""
        from fontrx.kernels.sdf_pallas import sdf_pallas_batch

        batch = (glyph_batch(dejavu, "Wé8", 40, 52) if which == "dejavu"
                 else glyph_batch(cjk, CJK_CHARS, 40, 52))
        want = sdf_pallas_batch(*jax_args(batch), height=40, width=128,
                                interpret=True)[:, :36, :52]
        assert_close(port_sdf(batch, 36, 52), want, batch, 36, 52)

    def test_sdf32_gate(self, dejavu):
        """The sdf32 family (``benchmarks/full_gate.py:316-366``): against the
        jnp fallback with the oracle's sign, both clipped to +-8, within
        8/127 px."""
        from fontrx.kernels.sdf import sdf_batch as sdf_jnp

        batch = glyph_batch(dejavu, "AQg@&%Wb", 32, 32)
        segs, min_x, max_y, scale = batch
        jnp_dist = np.abs(np.asarray(sdf_jnp(*jax_args(batch), height=32, width=32)))
        sign = np.stack([np.where(inside_oracle(segs[i], min_x[i], max_y[i], scale, 32, 32,
                                                False), f32(1), f32(-1))
                         for i in range(len(segs))])
        want = np.clip(sign * jnp_dist, -8, 8)
        port = port_sdf(batch, 32, 32)
        assert int((np.abs(port - want) > 8 / 127).sum()) == 0
        assert (np.abs(port) < 8).mean() > 0.3  # the band is not empty

    @pytest.mark.parametrize("spread", [8.0, 127.0, 63.5, 3.0])
    def test_sdf_to_u8_equals_jax(self, spread):
        from fontrx.kernels.sdf import sdf_to_u8

        rng = np.random.default_rng(7)
        vals = rng.uniform(-1.2 * spread, 1.2 * spread, (3, 17, 19)).astype(f32)
        # exact .5 ties: 128 + v * 127/spread lands on k + 0.5
        k = f32(127.0 / spread)
        ties = (np.arange(-8, 8, dtype=f32) + f32(0.5)) / k
        exact = (f32(128) + ties * k) % 1 == 0.5
        vals[0, 0, :16] = ties
        vals[0, 1, :4] = [0.0, -0.0, spread, -spread]
        port = sdf_ref.sdf_to_u8(torch.from_numpy(vals), spread)
        assert port.dtype == torch.uint8
        np.testing.assert_array_equal(port.numpy(), np.asarray(sdf_to_u8(vals, spread)))
        if spread in (127.0, 63.5):
            assert exact.all()  # the ties are real ties at these spreads

    @pytest.mark.parametrize("pack", [False, True])
    def test_engine_vs_jax_engine(self, cjk, pack):
        """``RasterEngine.sdf_batch`` then ``sdf_to_u8`` against the JAX
        engine's, with its tiled route (``pack_sdf``) and without it."""
        from fontrx.engine.raster import RasterEngine as JaxEngine
        from fontrx.kernels.sdf import sdf_to_u8

        batch = glyph_batch(cjk, CJK_CHARS, 64, 64)
        engine = RasterEngine(device="cpu")
        out = engine.sdf_batch(*batch, height=64, width=64)
        jengine = JaxEngine(backend="interpret")
        packed = jengine.pack_sdf(*batch, height=64, width=64) if pack else None
        assert (packed is not None) == pack
        jout = np.asarray(jengine.sdf_batch(*batch, height=64, width=64, pack=packed))
        assert out.dtype == torch.float32 and tuple(out.shape) == (4, 64, 64)
        assert_close(out.numpy(), jout, batch, 64, 64)
        u8 = engine.sdf_to_u8(out).numpy().astype(np.int16)
        ju8 = np.asarray(sdf_to_u8(jout)).astype(np.int16)
        differ = u8 != ju8
        assert np.abs(u8 - ju8).max() <= 1
        assert (np.abs(out.numpy() - jout)[differ] <= TOL).all()


def hand_batch():
    """Vertical lines beside a 16 x 16 tile at scale 1 (an em unit is a
    pixel), whose last column samples x = 15: at x = 23, exactly spread
    (8 px) from it; at 24, exactly spread + 1 px, the band's edge; at 24.5,
    beyond it. A parabola inside the tile gives a band."""
    segs = np.zeros((4, 3, 3, 2), f32)
    for b, x in enumerate((23, 24, 24.5)):
        segs[b, 0] = [[x, -40], [x, 0], [x, 40]]
    segs[3, 0] = [[2, 2], [8, 30], [14, 2]]
    segs[3, 1] = [[24, 10], [24, 0], [24, -10]]
    return segs, np.zeros(4, np.int32), np.full(4, 15, np.int32), f32(1.0)


def sdf_keep(segments, min_x, max_y, scale, *, height, width, spread_px=8.0, box=(16, 16)):
    """The kernel's cull (``csrc/sdf.cu``) in NumPy float64, per glyph: bool
    ``[T, S]`` over the boxes of ``box = (rows, columns)`` pixels that cut
    the raster from its corner (row-major, clipped to it) and the segments.
    A segment is kept for a box unless it is all zero or the box distance
    between its control hull and the box's pixels exceeds ``spread + 1 px``
    (K11's rule, ``sdf_pallas.py:408-426``). At 16 x 16 it is K11's host
    pack; at ``bound.SDF_CULL_BOX`` the kernel's, per pixel slot of a warp."""
    seg = np.asarray(segments, f32)
    scale = float(f32(scale))
    margin = (float(f32(spread_px)) + 1.0) / scale
    bh, bw = box
    c0, r0 = np.arange(0, width, bw), np.arange(0, height, bh)
    c1, r1 = np.minimum(c0 + bw, width) - 1, np.minimum(r0 + bh, height) - 1
    for b in range(seg.shape[0]):
        q = seg[b].astype(np.float64)
        dead = (seg[b] == 0).all(axis=(1, 2))
        mx, my = float(min_x[b]), float(max_y[b])
        # the boxes, [T, 1] each
        bx0, bx1 = (np.tile((mx + v) / scale, len(r0))[:, None] for v in (c0, c1))
        by1, by0 = (np.repeat((my - v) / scale, len(c0))[:, None] for v in (r0, r1))
        dx = np.maximum(np.maximum(q[:, :, 0].min(1) - bx1, bx0 - q[:, :, 0].max(1)), 0.0)
        dy = np.maximum(np.maximum(q[:, :, 1].min(1) - by1, by0 - q[:, :, 1].max(1)), 0.0)
        yield ~(dx * dx + dy * dy > margin * margin) & ~dead[None]


def folded_pair_dist_sq(seg, px, py):
    """``sdf_ref._pair_dist_sq`` in the association ``csrc/sdf.cu`` runs it:
    what depends on the segment alone or on it and a constant ``t`` (0 * ax,
    0 * bx2, 0 * ay, 0 * by2; 2 ax, 2 ay; per start value t0, (k3 t0 + k2) t0
    and (3 k3 t0 + 2 k2) t0) computed once per segment, then the pair's
    program from them. Same arguments and shapes."""
    p0x, p0y = seg[..., 0, 0], seg[..., 0, 1]
    p1x, p1y = seg[..., 1, 0], seg[..., 1, 1]
    p2x, p2y = seg[..., 2, 0], seg[..., 2, 1]
    dev = seg.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    two = 2 * one
    ax = p1x - p0x
    ay = p1y - p0y
    bx2 = p0x - 2 * p1x + p2x
    by2 = p0y - 2 * p1y + p2y
    k3 = bx2 * bx2 + by2 * by2
    k2 = 3 * (ax * bx2 + ay * by2)
    k1 = 2 * (ax * ax + ay * ay)
    k3x3 = 3 * k3
    k2x2 = 2 * k2
    # the segment's folded terms
    zax, zbx, zay, zby = zero * ax, zero * bx2, zero * ay, zero * by2
    ax2, ay2 = two * ax, two * ay
    starts = [torch.tensor(t0, device=dev) for t0 in sdf_ref.START_VALUES]
    cs = [(k3 * t0 + k2) * t0 for t0 in starts]
    ds = [(k3x3 * t0 + k2x2) * t0 for t0 in starts]

    qx = p0x - px
    qy = p0y - py
    qa = qx * ax + qy * ay
    qb = qx * bx2 + qy * by2
    k1b = k1 + qb
    best = (qx + zax + zbx) * (qx + zax + zbx) + (qy + zay + zby) * (qy + zay + zby)
    best = torch.minimum(best, (qx + ax2 + bx2) * (qx + ax2 + bx2)
                         + (qy + ay2 + by2) * (qy + ay2 + by2))
    for t0, c, d in zip(starts, cs, ds):
        f = (c + k1b) * t0 + qa
        df = d + k1b
        df = torch.where(df == 0, one, df)
        t = torch.clamp(t0 - f / df, 0.0, 1.0)
        for _ in range(sdf_ref.NEWTON_ITERS - 1):
            f = ((k3 * t + k2) * t + k1b) * t + qa
            df = (k3x3 * t + k2x2) * t + k1b
            df = torch.where(df == 0, one, df)
            t = torch.clamp(t - f / df, 0.0, 1.0)
        t2 = 2 * t
        tt = t * t
        dx = qx + t2 * ax + tt * bx2
        dy = qy + t2 * ay + tt * by2
        best = torch.minimum(best, dx * dx + dy * dy)
    dead = (seg == 0).flatten(-2).all(dim=-1)
    return torch.where(dead, torch.inf, best)


def fold_segments():
    """Segments float32 ``[n, 3, 2]`` for the fold test: random ones from a
    seed, and adversarial ones: -0, subnormals, coordinates near 2^60 and
    2^-60, a flat and a degenerate (straight) quadratic, all-zero padding,
    and infinities and NaN, which the wrapper accepts."""
    rng = np.random.default_rng(2024)
    random = rng.uniform(-64, 64, (40, 3, 2)).astype(f32)
    tiny = f32(1.4e-45)
    adversarial = np.array([
        [[-0.0, 0.0], [0.0, -0.0], [-0.0, -0.0]],
        [[-0.0, 3.0], [1.0, -0.0], [0.0, -2.0]],
        [[tiny, -tiny], [2 * tiny, tiny], [-tiny, 3 * tiny]],
        [[1e-39, 2e-39], [-3e-39, 1e-39], [5e-39, -7e-39]],
        [[2.0**60, 1.0], [2.0**60 + 2.0**37, -3.0], [-(2.0**60), 5.0]],
        [[2.0**-60, 2.0**-61], [3 * 2.0**-60, -(2.0**-59)], [2.0**-58, 2.0**-60]],
        [[1.0, 5.0], [4.0, 5.0], [9.0, 5.0]],           # flat in y
        [[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]],           # a straight quadratic
        [[2.0, -1.0], [2.0, -1.0], [2.0, -1.0]],        # a point
        [[0.0, 0.0], [0.0, 0.0], [0.0, 0.0]],           # padding
        [[np.inf, 0.0], [1.0, 1.0], [2.0, 0.0]],
        [[0.0, 0.0], [-np.inf, 1.0], [2.0, np.inf]],
        [[np.nan, 1.0], [1.0, 2.0], [3.0, 1.0]],
        [[0.0, 1.0], [1.0, np.nan], [3.0, 1.0]],
    ], f32)
    return np.concatenate([random, adversarial])


class TestCull:
    """The cull (``sdf_keep``: the rule ``csrc/sdf.cu`` applies per pixel
    slot of a warp, ``bound.SDF_CULL_BOX``, and K11's host pack per 16 x 16
    tile) drops only segments that cannot change a pixel: the plain version
    over each box's kept segments alone equals the plain version over all of
    them, bit for bit."""

    @staticmethod
    def assert_conservative(batch, h, w, box):
        segs, min_x, max_y, scale = batch
        bh, bw = box
        full = port_sdf(batch, h, w)
        boxes_x = -(-w // bw)
        for b, keep in enumerate(sdf_keep(segs, min_x, max_y, scale, height=h, width=w,
                                          box=box)):
            for t in range(keep.shape[0]):
                r0, c0 = (t // boxes_x) * bh, (t % boxes_x) * bw
                th, tw = min(bh, h - r0), min(bw, w - c0)
                kept = np.where(keep[t][:, None, None], segs[b], f32(0))[None]
                anchors = (np.array([min_x[b] + c0], np.int32),
                           np.array([max_y[b] - r0], np.int32))
                d2 = sdf_ref.min_dist_sq(*tensors(kept, *anchors, scale), height=th, width=tw)
                dist = torch.minimum(winding_ref.sqrt_rn(d2) * torch.tensor(scale),
                                     torch.tensor(f32(8)))
                np.testing.assert_array_equal(
                    dist.numpy()[0].view(np.int32),
                    np.abs(full[b, r0:r0 + th, c0:c0 + tw]).view(np.int32))

    @pytest.mark.parametrize("box", BOXES)
    def test_random_batch(self, box, one_torch_thread):
        batch = random_batch(64)
        self.assert_conservative(batch, 64, 64, box)
        keep = np.concatenate(list(sdf_keep(*batch, height=64, width=64, box=box)))
        assert 0 < keep.mean() < 1  # it does cull

    @pytest.mark.parametrize("box", BOXES)
    def test_glyphs_with_edge_tiles(self, dejavu, box, one_torch_thread):
        self.assert_conservative(glyph_batch(dejavu, "W@", 40, 40), 36, 52, box)

    @pytest.mark.parametrize("box", BOXES)
    def test_segment_at_the_band_edge(self, box, one_torch_thread):
        batch = hand_batch()
        t = 15 // box[1]  # the box of the first rows that holds column 15
        keep = [k[t] for k in sdf_keep(*batch, height=16, width=16, box=box)]
        assert keep[0][0] and keep[1][0] and not keep[2][0]  # spread + 1 px is kept
        assert keep[3].tolist() == [True, True, False]  # dead rows are not
        self.assert_conservative(batch, 16, 16, box)
        out = np.abs(port_sdf(batch, 16, 16))
        assert (out[0, :, 15] == 8).all() and (out[0, :, :15] == 8).all()
        assert (out[1:3] == 8).all() and (out[3] < 8).any()

    @pytest.mark.parametrize("box", BOXES)
    @pytest.mark.parametrize("h,w", [(64, 64), (36, 52)])
    def test_kept_pairs_count(self, dejavu, box, h, w, one_torch_thread):
        """``bound.sdf_kept_pairs`` counts each box's kept segments times
        its pixels in the raster."""
        for batch in (random_batch(max(h, w)), glyph_batch(dejavu, "W@g", min(h, w), max(h, w))):
            segs, min_x, max_y, scale = batch
            bh, bw = box
            rows = np.minimum(np.arange(0, h, bh) + bh, h) - np.arange(0, h, bh)
            cols = np.minimum(np.arange(0, w, bw) + bw, w) - np.arange(0, w, bw)
            pixels = (rows[:, None] * cols[None, :]).reshape(-1)
            want = sum(int((keep.sum(axis=1) * pixels).sum())
                       for keep in sdf_keep(*batch, height=h, width=w, box=box))
            assert bound.sdf_kept_pairs(*batch, height=h, width=w, box=box) == want > 0

    def test_cull_box_is_the_kernels(self):
        """``bound.SDF_CULL_BOX`` is ``csrc/sdf.cu``'s warp box, ``(kBoxH,
        kBoxW)`` with ``kBoxH = 32 / kBoxW``: a pixel a lane."""
        src = (ROOT / "fontrx_torch" / "csrc" / "sdf.cu").read_text()
        box_w = int(re.search(r"constexpr int kBoxW = (\d+);", src).group(1))
        assert re.search(r"constexpr int kBoxH = 32 / kBoxW;", src)
        assert bound.SDF_CULL_BOX == (32 // box_w, box_w)

    @pytest.mark.parametrize("size", [32, 64])
    def test_sdf_keep_matches_pack_sdf_tiles(self, size):
        """Per 16 x 16 tile, the segments the kernel keeps are those K11's
        host pack lists, on the JAX package's SDF test batch."""
        from fontrx.kernels.sdf_pallas import pack_sdf_tiles

        seg, min_x, max_y, scale = random_batch(size)
        chunk = 8
        stream, _cnts, tile_ids, cap = pack_sdf_tiles(seg, min_x, max_y, scale, size, size,
                                                      tile_h=16, tile_w=16, seg_chunk=chunk)
        n_tiles = (size // 16) ** 2
        n_g = 1024 // 256
        rows = stream.reshape(3, n_tiles // n_g, cap, n_g, chunk, 6)
        # slot s = (register r, group g): its live rows, over all chunks
        listed = (rows != 0).any(axis=-1).sum(axis=(2, 4)).reshape(3, n_tiles)
        listed = np.take_along_axis(listed, np.argsort(tile_ids, axis=1), axis=1)
        keep = np.stack(list(sdf_keep(seg, min_x, max_y, scale, height=size, width=size)))
        np.testing.assert_array_equal(keep.sum(axis=2), listed)


class TestFold:
    """``csrc/sdf.cu``'s folded association, mirrored in torch, against the
    plain version's per-pair program: bit for bit as int32 patterns, on
    random and adversarial segments and sample points."""

    @pytest.mark.parametrize("points", ["grid", "adversarial"])
    def test_folded_terms_are_bit_equal(self, points, one_torch_thread):
        seg = torch.from_numpy(fold_segments())[None, :, None, None]  # [1, C, 1, 1, 3, 2]
        if points == "grid":
            px = torch.from_numpy(np.linspace(-70, 70, 23).astype(f32))
            py = torch.from_numpy(np.linspace(-70, 70, 19).astype(f32))
        else:
            vals = np.array([0.0, -0.0, 1.4e-45, -1e-39, 2.0**60, -(2.0**-60), 1.0, 2.0,
                             5.0, 9.0], f32)
            px, py = torch.from_numpy(vals), torch.from_numpy(vals[::-1].copy())
        px = px[None, None, None, :]
        py = py[None, None, :, None]
        want = sdf_ref._pair_dist_sq(seg, px, py)
        got = folded_pair_dist_sq(seg, px, py)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.numpy().view(np.int32))
        assert torch.isnan(want).any() and torch.isinf(want).any()  # the cases reach both


class TestWrapper:
    def test_cpu_tensor_runs_plain_version(self, dejavu):
        batch = glyph_batch(dejavu, "Rx", 40, 48)
        before = sdf.launches, winding.launches
        out = sdf.sdf_batch(*tensors(*batch), height=48, width=48, spread_px=5.0)
        assert (sdf.launches, winding.launches) == before
        assert out.dtype == torch.float32 and out.device.type == "cpu"
        np.testing.assert_array_equal(out.numpy(), port_sdf(batch, 48, 48, spread_px=5.0))

    def test_cpu_engine_never_launches(self, dejavu):
        before = sdf.launches, winding.launches
        out = RasterEngine(device="cpu").sdf_batch(*glyph_batch(dejavu, "k", 24, 24),
                                                   height=24, width=24)
        assert (sdf.launches, winding.launches) == before and out.device.type == "cpu"

    @pytest.mark.parametrize("b,s", [(0, 4), (2, 0)])
    def test_empty(self, b, s):
        segs = np.zeros((b, s, 3, 2), f32)
        out = RasterEngine(device="cpu").sdf_batch(segs, np.zeros(b, np.int32),
                                                   np.zeros(b, np.int32), 1.0,
                                                   height=5, width=7)
        assert tuple(out.shape) == (b, 5, 7)
        assert (out == -8).all()  # no segment: outside, at the spread


def card_batches(h, w):
    """The random batch (dead rows, ``min_x = 3``) and glyphs, at ``h x w``."""
    font = Font.open(DEJAVU)
    return [random_batch(max(h, w)), glyph_batch(font, "AQg@&%Wb", min(h, w), max(h, w))]


@pytest.mark.requires_cuda
class TestKernelOnCard:
    @pytest.mark.parametrize("b", [0, 3])
    @pytest.mark.parametrize("h,w", [(32, 32), (64, 64), (256, 256), (36, 52)])
    def test_kernel_matches_ref(self, cuda, b, h, w):
        for segs, min_x, max_y, scale in card_batches(h, w):
            args = tensors(segs[:b], min_x[:b], max_y[:b], scale, cuda)
            before = sdf.launches
            out = sdf.sdf_batch(*args, height=h, width=w)
            torch.cuda.synchronize()
            assert sdf.launches == before + (1 if b else 0)
            want = sdf_ref.sdf_batch(*args, height=h, width=w)
            assert out.dtype == torch.float32 and tuple(out.shape) == (b, h, w)
            assert torch.equal(out.view(torch.int32), want.view(torch.int32))
            assert torch.equal(sdf.sdf_to_u8(out), sdf_ref.sdf_to_u8(want))

    @pytest.mark.parametrize("h,w", [(1, 1), (5, 3), (8, 4), (17, 33), (31, 47), (40, 9)])
    def test_partial_boxes_and_a_glyph_without_segments(self, cuda, h, w):
        """Rasters that are not whole tiles, warp boxes or pixel slots, and a
        glyph whose segments are all padding."""
        segs, min_x, max_y, scale = random_batch(max(h, w), b=4)
        segs[2] = 0.0
        args = tensors(segs, min_x, max_y, scale, cuda)
        out = sdf.sdf_batch(*args, height=h, width=w)
        want = sdf_ref.sdf_batch(*args, height=h, width=w)
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))
        assert (out[2] == -8).all()

    @pytest.mark.parametrize("n", [1, 6, 127, 128, 129, 300])
    def test_segment_counts_across_chunks(self, cuda, n):
        """Segment counts below, at and past the kernel's chunk of segments."""
        args = tensors(*random_batch(48, n=n), cuda)
        out = sdf.sdf_batch(*args, height=48, width=48)
        want = sdf_ref.sdf_batch(*args, height=48, width=48)
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))

    @pytest.mark.parametrize("spread", [0.0, 1.0, 2.5, 12.0, 40.0])
    def test_spread_options(self, cuda, spread):
        args = tensors(*random_batch(64), cuda)
        out = sdf.sdf_batch(*args, height=64, width=64, spread_px=spread)
        want = sdf_ref.sdf_batch(*args, height=64, width=64, spread_px=spread)
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))

    def test_segment_at_the_band_edge(self, cuda):
        args = tensors(*hand_batch(), cuda)
        out = sdf.sdf_batch(*args, height=16, width=16)
        want = sdf_ref.sdf_batch(*args, height=16, width=16)
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))

    def test_engine_on_card(self, cuda, cjk):
        batch = glyph_batch(cjk, CJK_CHARS, 64, 64)
        before = sdf.launches, winding.launches
        out = RasterEngine(device=cuda).sdf_batch(*batch, height=64, width=64)
        assert (sdf.launches, winding.launches) == (before[0] + 1, before[1] + 1)
        assert out.device.type == "cuda"
        np.testing.assert_array_equal(out.cpu().numpy().view(np.int32),
                                      port_sdf(batch, 64, 64).view(np.int32))

    def test_wrapper_rejects_bad_inputs(self, cuda):
        segs = torch.zeros((2, 4, 3, 2), device=cuda)
        anchors = torch.zeros(2, dtype=torch.int32, device=cuda)
        wmap = torch.zeros((2, 8, 8), dtype=torch.int32, device=cuda)
        before = sdf.launches, winding.launches
        with pytest.raises(TypeError):
            sdf.sdf_batch(segs.double(), anchors, anchors, 1.0, height=8, width=8)
        with pytest.raises(ValueError):
            sdf.sdf_batch(segs, anchors[:1], anchors, 1.0, height=8, width=8)
        with pytest.raises(ValueError):
            sdf.sdf_batch(segs, anchors, anchors, 0.0, height=8, width=8)
        with pytest.raises(ValueError):
            sdf.sdf_batch(segs, anchors, anchors, 1.0, height=8, width=8, spread_px=-1.0)
        with pytest.raises(ValueError):
            sdf.sdf_from_winding(segs, anchors, anchors, 1.0, wmap[:, :4], height=8, width=8)
        with pytest.raises(TypeError):
            sdf.sdf_from_winding(segs, anchors, anchors, 1.0, wmap.float(), height=8, width=8)
        assert (sdf.launches, winding.launches) == before

    def test_failed_launch_raises(self, cuda, monkeypatch):
        """The kernel's entry refuses a negative segment count; the wrapper
        raises and counts no launch."""
        lib = _build.load("sdf")

        class BadCount:
            @staticmethod
            def sdf(*args):
                args = list(args)
                args[7] = -1  # S
                return lib.sdf(*args)

        monkeypatch.setattr(_build, "load", lambda name: BadCount)
        segs = torch.zeros((1, 4, 3, 2), device=cuda)
        anchors = torch.zeros(1, dtype=torch.int32, device=cuda)
        wmap = torch.zeros((1, 8, 8), dtype=torch.int32, device=cuda)
        before = sdf.launches
        with pytest.raises(RuntimeError, match="sdf kernel launch failed"):
            sdf.sdf_from_winding(segs, anchors, anchors, 1.0, wmap, height=8, width=8)
        assert sdf.launches == before
