"""fontrx_torch's 2 x 2 MSAA page and its single-sample page at a sample
offset: the plain PyTorch version and ``PageRenderer.render_direct`` on the
CPU against the JAX package (its Pallas kernels in interpret mode), each
plane of K8's pair function against ``winding_page_msaa_batch``, a model of
the CUDA kernel's row cull proved conservative at ``oy = +-0.25``, the
wrapper's checks, and the CUDA kernel against the plain version on the card.

Tolerance everywhere: 0 differing pixels (the int32 winding where both
sides give it).

The module imports JAX only inside the fixtures and tests that compare with
it, so the card's tests also run where there is no JAX:
``python -m pytest --noconftest -m requires_cuda tests/test_torch_page_msaa.py``.
"""

import numpy as np
import pytest
import torch

from fontrx_torch.kernels import _build, page, page_ref
from fontrx_torch.scene.layout import layout_text
from fontrx_torch.scene.page import PageRenderer
from fontrx_torch.scene.transform import ViewTransform
from tests.test_torch_page import (
    FONT, SIZES, TEXT, init_view, near_lines, on_rows, page_stream, renderer, sliver_page,
    views, zoomed_views)

f32 = np.float32
OYS = (-0.25, 0.25)
# single-sample offsets held to the JAX package's _direct_page_step
OFFSETS = ((0.25, -0.25), (-0.25, 0.25), (1 / 3, 1 / 3))
# (size, view) cases: view 0 is the first view, 1-3 the zoomed ones
CASES = [pytest.param(size, k, id=size if k == 0 else f"{size}-zoomed{k}")
         for size in sorted(SIZES) for k in range(4)]


@pytest.fixture(scope="module")
def font():
    from fontrx_torch.font.font import Font

    return Font.open(FONT)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def ref_inputs(pr, view, w, h):
    """What the JAX package's ``render_direct`` hands its page steps: the
    compacted stream padded to 2048 segments and the instance offsets padded
    to 256 rows (``page.py:430-447``)."""
    import jax.numpy as jnp

    slots, offsets_em = pr.layout.instance_arrays()
    flat, idx = pr._compact_instances(slots)
    em = offsets_em.astype(np.float64)
    ndc_x = em[:, 0] * view.scale[0] + view.offset[0]
    ndc_y = (em[:, 1] * view.scale[1] + view.offset[1]) * view.aspect_ratio
    xs = np.full((((len(slots) + 1 + 255) // 256) * 256, 2), -1e7, f32)
    xs[: len(slots), 0] = (ndc_x + 1.0) / 2.0 * w
    xs[: len(slots), 1] = (ndc_y + 1.0) / 2.0 * h
    return flat, idx, jnp.asarray(xs), f32(view.scale[0] * (w / 2.0))


@pytest.fixture(scope="module")
def jax_pages():
    """The JAX package's pages of each size at each view: the MSAA page of
    ``render_direct`` and the single-sample pages of ``_direct_page_step``
    at ``OFFSETS``, as NumPy."""
    from fontrx.engine.raster import RasterEngine
    from fontrx.font.font import Font as RefFont
    from fontrx.scene import page as ref_page
    from fontrx.scene.layout import layout_text as ref_layout
    from fontrx.scene.transform import ViewTransform as RefView

    ref_font = RefFont.open(str(FONT))
    out = {}
    for size, (w, h) in SIZES.items():
        pr = ref_page.PageRenderer(ref_font, ref_layout(ref_font, TEXT), w, h, RasterEngine())
        v = RefView.init(ref_font.info.units_per_em, w, h)
        ref_views = [v, v.zoomed(-0.5, (0.1, 0.1)),
                     v.zoomed(0.5, (0.1, 0.1)).dragged(0.01, 0.005), v.zoomed(-8.0, (0.0, 0.0))]
        for k, view in enumerate(ref_views):
            out[size, k, "msaa"] = np.asarray(pr.render_direct(view, msaa=True))
            inputs = ref_inputs(pr, view, w, h)
            for off in OFFSETS:
                out[size, k, off] = np.asarray(ref_page._direct_page_step(
                    *inputs, page_h=h, page_w=w, interpret=True, sample_offset=off))
    return out


@pytest.fixture(scope="module")
def jax_planes(font):
    """Each plane of ``winding_page_msaa_batch(interpret=True)`` on the wide
    page at each view and ``oy``, from the port's page-space segments padded
    as the reference pads them: int32 ``[2, h, w]``."""
    import jax.numpy as jnp

    from fontrx.kernels.winding_page import winding_page_msaa_batch

    w, h = SIZES["k7"]
    pw, ph = page_ref.padded_width(w), -(-h // 128) * 128
    pr = renderer(font, "k7")
    out = {}
    for k, view in enumerate(views(font, "k7")):
        q = page_ref.transform_segments(*pr.page_inputs(view))
        cap = -(-len(q) // 2048) * 2048
        q = torch.cat([q, torch.full((cap - len(q), 3, 2), page_ref.PAD_POINT)])
        for oy, oxs in page_ref.msaa_lattice():
            wd = winding_page_msaa_batch(
                jnp.asarray(q.numpy())[None], jnp.zeros(1, jnp.int32),
                jnp.full(1, h - 1, jnp.int32), f32(1.0), height=ph, width=pw, interpret=True,
                sample_oy=oy, sample_oxs=oxs, seg_chunk=32,
                tile_w=256 if pw % 256 == 0 else 128, row_windows=8)
            out[k, oy] = np.asarray(wd)[0, :, :h, :w]
    return out


class TestAgainstJax:
    @pytest.mark.parametrize("size,k", CASES)
    def test_msaa_page(self, font, jax_pages, size, k):
        want = jax_pages[size, k, "msaa"]
        assert set(np.unique(want)) <= {0, 63, 127, 191, 255}
        assert ((want > 0) & (want < 255)).sum() > 100  # edge pixels on the page
        got = renderer(font, size).render_direct(views(font, size)[k], msaa=True)
        assert got.dtype == torch.uint8 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("off", OFFSETS, ids=["+-", "-+", "third"])
    @pytest.mark.parametrize("size,k", CASES)
    def test_page_at_a_sample_offset(self, font, jax_pages, size, k, off):
        w, h = SIZES[size]
        got = page_ref.direct_page(*renderer(font, size).page_inputs(views(font, size)[k]),
                                   page_h=h, page_w=w, sample_offset=off)
        np.testing.assert_array_equal(got.numpy(), jax_pages[size, k, off])

    @pytest.mark.parametrize("oy", OYS)
    @pytest.mark.parametrize("k", range(4))
    def test_pair_planes(self, font, jax_planes, k, oy):
        """Each plane of the port's pair function is K8's, at the first and
        the zoomed views. Run with ``-s`` to print where a plane differs from
        the single-sample page at its offset."""
        w, h = SIZES["k7"]
        pr = renderer(font, "k7")
        q = page_ref.transform_segments(*pr.page_inputs(views(font, "k7")[k])).reshape(-1, 6)
        oxs = dict(page_ref.msaa_lattice())[oy]
        pair = page_ref.windings(q, h - 1, h, w, oy, oxs)
        want = jax_planes[k, oy]
        assert pair.shape == want.shape == (2, h, w)
        np.testing.assert_array_equal(pair.numpy(), want)
        single = [page_ref.windings(q, h - 1, h, w, oy, (ox,))[0] for ox in oxs]
        differ = [int((pair[i] != single[i]).sum()) for i in range(2)]
        print(f"view {k} oy {oy}: pixels where the pair's planes differ from single passes "
              f"{differ}")

    def test_msaa_lattice(self):
        assert page_ref.msaa_lattice() == [(-0.25, (-0.25, 0.25)), (0.25, (-0.25, 0.25))]

    @pytest.mark.parametrize("size", sorted(SIZES))
    def test_msaa_is_the_mean_of_the_four_fills(self, font, size):
        """Fills summed as integers, then floor-divided by 4: never the
        coverage rounding ``count * f32(1/4)``."""
        w, h = SIZES[size]
        inputs = renderer(font, size).page_inputs(zoomed_views(font, w, h)[0])
        fills = sum((page_ref.direct_page(*inputs, page_h=h, page_w=w, sample_offset=(ox, oy))
                     .to(torch.int32)) for oy, oxs in page_ref.msaa_lattice() for ox in oxs)
        got = page_ref.direct_page_msaa(*inputs, page_h=h, page_w=w)
        if size == "v2":  # the narrow route is four single passes
            assert torch.equal(got, (fills // 4).to(torch.uint8))
        assert set(torch.unique(got).tolist()) == {0, 63, 127, 191, 255}


# -- the kernel's row cull at the sample offset ---------------------------------


def offset_slivers(rows, oy, seed=0, n=96):
    """Quadratics whose control hull's top (or bottom) lies one ulp below
    (above) a sample row ``y = r + oy``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        y0 = f32(rng.integers(8, rows - 8)) + f32(oy)
        span = f32(rng.uniform(0.5, 60.0))
        if i % 2:
            edge = np.nextafter(y0, f32(-np.inf))
            far = f32(edge - span)
        else:
            edge = np.nextafter(y0, f32(np.inf))
            far = f32(edge + span)
        mid = f32(rng.uniform(min(edge, far), max(edge, far)))
        p0, p2 = (edge, far) if rng.random() < 0.5 else (far, edge)
        x = rng.uniform(0, 400, 3).astype(f32)
        out.append([x[0], p0, x[1], mid, x[2], p2])
    return np.array(out, f32)


def stray_crossings(q, top, rows, page_w, oy, oxs=(-0.25, 0.25)):
    """Crossing (segment, row) pairs of the page at row offset ``oy`` that
    the row cull would not solve."""
    q = torch.as_tensor(q)
    roots, _ = page_ref.row_roots(q, page_ref.row_coords(top, rows, oy=oy))
    solved = page_ref.solved_rows(q, top, rows, page_w, oy, oxs)
    cull = page_ref.page_rows(q, top, rows, page_w, oy, oxs)
    return int(((roots > 0) & solved & ~cull).sum())


@pytest.mark.parametrize("oy", OYS)
class TestCull:
    ROWS = 256

    def cases(self, font, oy):
        yield "ulp slivers", offset_slivers(self.ROWS, oy)
        yield "near lines", near_lines(self.ROWS)
        yield "on rows", on_rows(self.ROWS) + np.array([0, oy] * 3, f32)
        for k, view in enumerate(zoomed_views(font, 480, self.ROWS)):
            yield f"zoomed page {k}", page_stream(font, 480, self.ROWS, view).numpy()

    def test_keeps_every_crossing(self, font, oy):
        for name, q in self.cases(font, oy):
            for page_w in (SIZES["v2"][0], SIZES["k7"][0]):  # both routes
                assert stray_crossings(q, self.ROWS - 1, self.ROWS, page_w, oy) == 0, name

    def test_slivers_cross_outside_the_hull(self, oy):
        q = torch.from_numpy(offset_slivers(self.ROWS, oy))
        cy = page_ref.row_coords(self.ROWS - 1, self.ROWS, oy=oy)
        roots, _ = page_ref.row_roots(q, cy)
        ys = q[:, 1::2]
        outside = (cy[None] > ys.amax(1)[:, None]) | (cy[None] < ys.amin(1)[:, None])
        assert ((roots > 0) & outside).sum() > 0

    def test_margin_one_row_short_drops_crossings(self, monkeypatch, oy):
        full = page_ref.margin
        monkeypatch.setattr(page_ref, "margin", lambda q, ymax: full(q, ymax) - 1.0)
        assert stray_crossings(offset_slivers(self.ROWS, oy), self.ROWS - 1, self.ROWS, 480,
                               oy) > 0

    def test_k7_margin_drops_near_line_crossings(self, monkeypatch, oy):
        monkeypatch.setattr(page_ref, "margin",
                            lambda q, ymax: torch.ones(len(q), dtype=torch.float64))
        assert stray_crossings(near_lines(self.ROWS), self.ROWS - 1, self.ROWS, 480, oy) > 0

    def test_row_coords_carry_the_offset(self, oy):
        cy = page_ref.row_coords(9, 4, oy=oy)
        assert cy.dtype == torch.float32 and cy.tolist() == [9 + oy, 8 + oy, 7 + oy, 6 + oy]


# -- the wrapper and the renderer on the CPU --------------------------------------


class TestWrapper:
    def test_cpu_tensor_runs_plain_version(self):
        inp = sliver_page(on_rows(64))
        before = (page.launches, page.msaa_launches)
        out = page.direct_page_msaa(*inp, page_h=64, page_w=128)
        one = page.direct_page(*inp, page_h=64, page_w=128, sample_offset=(0.25, 0.25))
        assert (page.launches, page.msaa_launches) == before
        assert out.dtype == torch.uint8 and out.shape == (64, 128)
        assert torch.equal(out, page_ref.direct_page_msaa(*inp, page_h=64, page_w=128))
        assert torch.equal(one, page_ref.direct_page(*inp, page_h=64, page_w=128,
                                                     sample_offset=(0.25, 0.25)))

    @pytest.mark.parametrize("off", [(float("nan"), 0.0), (0.0, float("inf"))])
    def test_check_rejects_a_sample_offset_that_is_not_finite(self, off):
        with pytest.raises(ValueError, match="sample_offset"):
            page.check_inputs(*sliver_page(on_rows(64)), 0, 64, 64, 64, "fill", off)

    def test_no_quiet_fallback(self):
        """A tensor that is not on the CPU never goes to the plain version."""
        seg = torch.empty((4, 3, 2), device="meta")
        idx = torch.empty(4, dtype=torch.int32, device="meta")
        offs = torch.empty((1, 2), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            page.direct_page_msaa(seg, idx, offs, 1.0, page_h=8, page_w=8)
        with pytest.raises(ValueError, match="CUDA"):
            page.direct_page(seg, idx, offs, 1.0, page_h=8, page_w=8, sample_offset=(0.25, 0))

    def test_build_failure_raises(self, monkeypatch):
        def fail(name):
            raise RuntimeError(f"nvcc failed for {name}")

        monkeypatch.setattr(_build, "load", fail)
        seg, idx, offs, s_px = sliver_page(on_rows(64))
        before = page.msaa_launches
        with pytest.raises(RuntimeError, match="nvcc failed for page"):
            page.launch_msaa(seg, idx, offs, s_px, len(seg), 1, 64, 64)
        assert page.msaa_launches == before

    def test_page_msaa_is_declared(self):
        assert set(_build._SIGNATURES["page"]) == {"page", "page_msaa"}


class TestRenderer:
    def test_band_is_fill_only(self, font):
        pr = renderer(font, "v2")
        for kw in ({"msaa": True}, {"debug": True}):
            with pytest.raises(ValueError, match="fill-only"):
                pr.render_direct(init_view(font, "v2"), band=(0, 16), **kw)

    def test_msaa_wins_over_debug(self, font):
        pr = renderer(font, "v2")
        view = zoomed_views(font, *SIZES["v2"])[1]
        assert torch.equal(pr.render_direct(view, msaa=True, debug=True),
                           pr.render_direct(view, msaa=True))

    @pytest.mark.parametrize("text", ["", "\n"])
    def test_empty_layout(self, font, text):
        w, h = SIZES["v2"]
        pr = PageRenderer(font, layout_text(font, text), w, h, "cpu")
        got = pr.render_direct(init_view(font, "v2"), msaa=True)
        assert got.dtype == torch.uint8 and got.shape == (h, w) and not got.any()

    @pytest.mark.parametrize("transparent", [False, True])
    def test_to_rgba(self, font, transparent):
        from fontrx.scene.page import PageRenderer as RefRenderer

        page_u8 = renderer(font, "v2").render_direct(init_view(font, "v2"), msaa=True)
        got = PageRenderer.to_rgba(page_u8, transparent)
        want = RefRenderer.to_rgba(page_u8.numpy(), transparent)
        assert got.dtype == np.uint8 and got.shape == page_u8.shape + (4,)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(PageRenderer.to_rgba(page_u8.numpy(), transparent), want)

    def test_to_rgba_of_a_colour_page_is_not_ported(self):
        """A colour page (uint8 ``[H, W, 3]``, ``render_color``'s) was not
        ported before the colour path; now it is the JAX package's opaque
        RGBA."""
        from fontrx.scene.page import PageRenderer as RefRenderer

        page_rgb = np.random.default_rng(3).integers(0, 256, (4, 5, 3), dtype=np.uint8)
        got = PageRenderer.to_rgba(page_rgb, transparent=True)
        assert got.shape == (4, 5, 4) and (got[..., 3] == 255).all()
        np.testing.assert_array_equal(got, RefRenderer.to_rgba(page_rgb, True))


# -- the kernel on the card -----------------------------------------------------------


@pytest.mark.requires_cuda
class TestKernelOnCard:
    def card_cases(self, font, cuda):
        """``(inputs, page_h, page_w)``: slivers on both routes, and each
        page at each view."""
        for q in (offset_slivers(256, 0.25), near_lines(256), on_rows(256)):
            inputs = tuple(t.to(cuda) if torch.is_tensor(t) else t for t in sliver_page(q))
            for w in (400, 1100):
                yield inputs, 256, w
        for size in sorted(SIZES):
            w, h = SIZES[size]
            pr = renderer(font, size, cuda)
            for view in views(font, size):
                yield pr.page_inputs(view), h, w

    def test_msaa_kernel_matches_plain_version(self, font, cuda):
        for inputs, h, w in self.card_cases(font, cuda):
            before = (page.launches, page.msaa_launches)
            got = page.direct_page_msaa(*inputs, page_h=h, page_w=w)
            torch.cuda.synchronize()
            assert (page.launches, page.msaa_launches) == (before[0], before[1] + 1)
            assert got.dtype == torch.uint8 and got.shape == (h, w)
            assert torch.equal(got, page_ref.direct_page_msaa(*inputs, page_h=h, page_w=w))

    def test_kernel_at_a_sample_offset_matches_plain_version(self, font, cuda):
        for inputs, h, w in self.card_cases(font, cuda):
            for off in OFFSETS:
                got = page.direct_page(*inputs, page_h=h, page_w=w, mode="winding",
                                       sample_offset=off)
                want = page_ref.direct_page(*inputs, page_h=h, page_w=w, mode="winding",
                                            sample_offset=off)
                assert torch.equal(got, want)
                band = page.direct_page(*inputs, 40, page_h=h, page_w=w, out_h=100,
                                        sample_offset=off)
                assert torch.equal(band, page_ref.direct_page(
                    *inputs, 40, page_h=h, page_w=w, out_h=100, sample_offset=off))

    def test_width_not_a_multiple_of_four(self, font, cuda):
        """The command line's page, 362 x 239: its bucket rows are padded to
        a stride of 364 cells, and the MSAA rows are written byte by byte."""
        w, h = 362, 239
        pr = PageRenderer(font, layout_text(font, TEXT), w, h, cuda)
        for view in [ViewTransform.init(font.info.units_per_em, w, h),
                     *zoomed_views(font, w, h)]:
            inputs = pr.page_inputs(view)
            before = page.msaa_launches
            got = page.direct_page_msaa(*inputs, page_h=h, page_w=w)
            torch.cuda.synchronize()
            assert page.msaa_launches == before + 1
            want = page_ref.direct_page_msaa(*inputs, page_h=h, page_w=w)
            assert got.shape == (h, w) and torch.equal(got, want)
            assert bool(((want > 0) & (want < 255)).any())

    def test_render_direct_msaa_launches_the_msaa_kernel_once(self, font, cuda):
        pr = renderer(font, "k7", cuda)
        view = zoomed_views(font, *SIZES["k7"])[0]
        before = (page.launches, page.msaa_launches)
        got = pr.render_direct(view, msaa=True)
        torch.cuda.synchronize()
        assert (page.launches, page.msaa_launches) == (before[0], before[1] + 1)
        assert torch.equal(got.cpu(), renderer(font, "k7").render_direct(view, msaa=True))

    def test_wrapper_rejects_bad_inputs(self, cuda):
        seg, idx, offs, _ = (t.to(cuda) if torch.is_tensor(t) else t
                             for t in sliver_page(on_rows(64)))
        before = page.msaa_launches
        with pytest.raises(TypeError):
            page.direct_page_msaa(seg.double(), idx, offs, 1.0, page_h=8, page_w=8)
        with pytest.raises(ValueError):
            page.direct_page_msaa(seg, idx, offs, 0.0, page_h=8, page_w=8)
        with pytest.raises(ValueError):
            page.direct_page_msaa(seg, idx, offs.cpu(), 1.0, page_h=8, page_w=8)
        assert page.msaa_launches == before

    def test_failed_launch_raises(self, cuda, monkeypatch):
        """The kernel's entry refuses a bad route; the wrapper raises and
        counts no launch."""
        lib = _build.load("page")

        class BadRoute:
            @staticmethod
            def page_msaa(*args):
                args = list(args)
                args[8] = 0  # chunk
                return lib.page_msaa(*args)

        monkeypatch.setattr(_build, "load", lambda name: BadRoute)
        inputs = tuple(t.to(cuda) if torch.is_tensor(t) else t for t in sliver_page(on_rows(64)))
        before = page.msaa_launches
        with pytest.raises(RuntimeError, match="page MSAA kernel launch failed"):
            page.direct_page_msaa(*inputs, page_h=64, page_w=64)
        assert page.msaa_launches == before
