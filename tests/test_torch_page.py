"""fontrx_torch direct page render: the plain PyTorch version and
``PageRenderer.render_direct`` on the CPU against the JAX package's
``render_direct`` (its Pallas kernels in interpret mode) and the NumPy
oracle, the band and the debug gray, the empty layout, a model of the CUDA
kernel's row cull proved conservative on slivers, the wrapper's checks, and
the CUDA kernel against the plain version and the winding kernel on the
card.

Tolerance everywhere: 0 differing pixels. The JAX package's page is held
at the first view and at zoomed ones. After a zoom ``s_px`` has many bits:
the transform then rounds (XLA fuses it into one multiply-add), and nearly
straight quadratics get roots on rows far from their hull, which the JAX
package's chunk cull keeps or drops (``page_ref``). The port computes that
same function, so its page equals the JAX package's there too; the winding
of every pair (``winding_ref``, ``csrc/winding.cu``) equals it only at the
first view.

The module imports JAX only inside the tests that compare with it, so the
card's tests also run where there is no JAX:
``python -m pytest --noconftest -m requires_cuda tests/test_torch_page.py``.
"""

import pathlib

import numpy as np
import pytest
import torch

from fontrx_torch.font.font import Font
from fontrx_torch.kernels import _build, page, page_ref, winding, winding_ref
from fontrx_torch.scene.layout import layout_text
from fontrx_torch.scene.page import PageRenderer
from fontrx_torch.scene.transform import ViewTransform

ROOT = pathlib.Path(__file__).resolve().parents[1]
FONT = ROOT / "fontrx_torch" / "data" / "DejaVuSans.ttf"
# the dirty-strip tests' text (tests/test_dirty_strip.py), three lines of it
TEXT = "\n".join(f"Paragraph {i}: quick brown foxes office {i}!" for i in range(3))
# a page on each side of the reference's split at 1024 px (page.py:190):
# its banded v2 route and its page kernel (K7)
SIZES = {"v2": (480, 256), "k7": (1100, 256)}
BAND = (64, 128)
f32 = np.float32


@pytest.fixture(scope="module")
def font():
    return Font.open(FONT)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def renderer(font, size, device="cpu", text=TEXT):
    w, h = SIZES[size]
    return PageRenderer(font, layout_text(font, text), w, h, device)


def init_view(font, size):
    w, h = SIZES[size]
    return ViewTransform.init(font.info.units_per_em, w, h)


def zoomed_views(font, w, h):
    """Views after config 5's kind of events (benchmarks/configs.py:287-295)
    and the stress page's zoom (benchmarks/stress.py:109): their s_px are
    not exact, so the transform rounds."""
    v = ViewTransform.init(font.info.units_per_em, w, h)
    return [v.zoomed(-0.5, (0.1, 0.1)), v.zoomed(0.5, (0.1, 0.1)).dragged(0.01, 0.005),
            v.zoomed(-8.0, (0.0, 0.0))]


def views(font, size):
    """The first view and the zoomed ones."""
    w, h = SIZES[size]
    return [init_view(font, size), *zoomed_views(font, w, h)]


# (size, view) cases: view 0 is the first view, 1-3 the zoomed ones
CASES = [pytest.param(size, k, id=size if k == 0 else f"{size}-zoomed{k}")
         for size in sorted(SIZES) for k in range(4)]


def sliver_page(q):
    """Page-space segments float32 ``[S, 6]`` as the page kernel's inputs:
    one instance at offset 0 and ``s_px = 1``, so the transform keeps them."""
    q = torch.as_tensor(np.asarray(q, f32)).reshape(-1, 3, 2).contiguous()
    return (q, torch.zeros(len(q), dtype=torch.int32), torch.zeros((1, 2)), 1.0)


def ulp_slivers(rows, seed=0, n=96):
    """Quadratics whose control hull's top (or bottom) lies one ulp below
    (above) a sample row: the float program often gives them a root on that
    row, just outside the hull."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        y0 = f32(rng.integers(8, rows - 8))
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


def near_lines(rows):
    """Lines whose control point sits a few ulps off their midpoint: ``a`` is
    tiny, the discriminant cancels, and the rounded roots stray up to the
    whole page away from the hull."""
    out = []
    for p0 in (200.0, 180.5, 240.25, rows - 20.0):
        p2 = p0 - 100.0
        for k in (1, 2, 3, 5, 8):
            for sgn in (1, -1):
                p1 = f32((p0 + p2) / 2) + f32(sgn * k * 2.0**-16)
                out.append([10.0, p0, 12.0, p1, 14.0, p2])
    return np.array(out, f32)


def on_rows(rows):
    """Segments lying exactly on a row, lines and curves ending on one, and a
    curve whose vertex touches one."""
    y = f32(rows // 2)
    return np.array([
        [0, y, 50, y, 100, y],               # flat, on the row
        [0, y, 5, y - 5, 10, y - 10],        # a line from the row down
        [0, y - 10, 5, y - 5, 10, y],        # a line up to the row
        [0, y - 8, 5, y + 8, 10, y - 8],     # vertex at y exactly
        [0, y, 5, y + 3, 10, y],             # a curve from the row and back
    ], f32)


def page_stream(font, w, h, view, text=TEXT):
    """A real page's page-space segments float32 ``[S, 6]`` under ``view``."""
    pr = PageRenderer(font, layout_text(font, text), w, h, "cpu")
    return page_ref.transform_segments(*pr.page_inputs(view)).reshape(-1, 6)


def stray_crossings(q, top, rows, page_w):
    """Crossing (segment, row) pairs of the page that the row cull would not
    solve."""
    q = torch.as_tensor(q)
    roots, _ = page_ref.row_roots(q, page_ref.row_coords(top, rows))
    solved = page_ref.solved_rows(q, top, rows, page_w)
    return int(((roots > 0) & solved & ~page_ref.page_rows(q, top, rows, page_w)).sum())


# -- against the JAX package --------------------------------------------------


@pytest.fixture(scope="module")
def jax_pages():
    """The JAX package's ``render_direct`` of each page at each view: fill,
    debug gray and ``BAND``, as NumPy."""
    from fontrx.engine.raster import RasterEngine
    from fontrx.font.font import Font as RefFont
    from fontrx.scene.layout import layout_text as ref_layout
    from fontrx.scene.page import PageRenderer as RefRenderer
    from fontrx.scene.transform import ViewTransform as RefView

    ref_font = RefFont.open(str(FONT))
    out = {}
    for size, (w, h) in SIZES.items():
        pr = RefRenderer(ref_font, ref_layout(ref_font, TEXT), w, h, RasterEngine())
        v = RefView.init(ref_font.info.units_per_em, w, h)
        ref_views = [v, v.zoomed(-0.5, (0.1, 0.1)),
                     v.zoomed(0.5, (0.1, 0.1)).dragged(0.01, 0.005), v.zoomed(-8.0, (0.0, 0.0))]
        for k, view in enumerate(ref_views):
            out[size, k] = {
                "fill": np.asarray(pr.render_direct(view)),
                "gray": np.asarray(pr.render_direct(view, debug=True)),
                "band": np.asarray(pr.render_direct(view, band=BAND)),
            }
    return out


@pytest.fixture(scope="module")
def port_windings(font):
    """The plain version's int32 page at each view, per size."""
    out = {}
    for size, (w, h) in SIZES.items():
        pr = renderer(font, size)
        for k, view in enumerate(views(font, size)):
            out[size, k] = page_ref.direct_page(*pr.page_inputs(view), page_h=h, page_w=w,
                                                mode="winding")
    return out


class TestAgainstJax:
    @pytest.mark.parametrize("size,k", CASES)
    def test_fill(self, font, jax_pages, port_windings, size, k):
        want = jax_pages[size, k]["fill"]
        assert (want != 0).sum() > 1000  # ink on the page
        got = renderer(font, size).render_direct(views(font, size)[k])
        assert got.dtype == torch.uint8 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(page_ref.finish(port_windings[size, k], "fill").numpy(),
                                      want)

    @pytest.mark.parametrize("size,k", CASES)
    def test_debug_gray(self, font, jax_pages, port_windings, size, k):
        got = renderer(font, size).render_direct(views(font, size)[k], debug=True)
        np.testing.assert_array_equal(got.numpy(), jax_pages[size, k]["gray"])
        np.testing.assert_array_equal(page_ref.finish(port_windings[size, k], "gray").numpy(),
                                      jax_pages[size, k]["gray"])

    @pytest.mark.parametrize("size,k", CASES)
    def test_band(self, font, jax_pages, size, k):
        y0, rows = BAND
        got = renderer(font, size).render_direct(views(font, size)[k], band=BAND)
        assert got.shape == (rows, SIZES[size][0])
        np.testing.assert_array_equal(got.numpy(), jax_pages[size, k]["band"])
        if k == 0:
            np.testing.assert_array_equal(got.numpy(),
                                          jax_pages[size, k]["fill"][y0 : y0 + rows])

    @pytest.mark.parametrize("size", sorted(SIZES))
    def test_zoomed_pages_need_the_chunk_cull_and_the_fused_transform(self, font, jax_pages,
                                                                     size):
        """The winding of every pair, a transform rounded twice, and both
        (the page before these two were found) each miss the JAX package's
        page after one zoom; at the first view all three equal it. Run with
        ``-s`` to print the differing pixels and the JAX page's ink."""
        w, h = SIZES[size]
        pr = renderer(font, size)
        anchors = (torch.zeros(1, dtype=torch.int32), torch.full((1,), h - 1, dtype=torch.int32))
        differ = []
        for k, view in enumerate(views(font, size)[:2]):
            seg, idx, offs, s_px = pr.page_inputs(view)
            twice = seg * torch.tensor(s_px) + offs[idx.long()][:, None, :]
            fused = page_ref.transform_segments(seg, idx, offs, s_px)
            every_pair, both = (
                page_ref.finish(winding_ref.winding_batch(flat[None], *anchors, 1.0, height=h,
                                                          width=w)[0], "fill")
                for flat in (fused, twice))
            rounded_twice = page_ref.direct_page(twice, torch.zeros_like(idx),
                                                 torch.zeros((1, 2)), 1.0, page_h=h, page_w=w)
            want = jax_pages[size, k]["fill"]
            differ.append(tuple(int((got.numpy() != want).sum())
                                for got in (every_pair, rounded_twice, both)))
            print(f"{size} {w}x{h} view {k}: differing pixels (every pair, rounded twice, "
                  f"both) {differ[-1]}; JAX page inks {int((want != 0).sum())} of {w * h}")
        assert differ[0] == (0, 0, 0)
        assert min(differ[1]) > 0, differ

    @pytest.mark.parametrize("text", ["", "\n\n", "   "])
    def test_empty_layout(self, font, text):
        from fontrx.engine.raster import RasterEngine
        from fontrx.font.font import Font as RefFont
        from fontrx.scene.layout import layout_text as ref_layout
        from fontrx.scene.page import PageRenderer as RefRenderer
        from fontrx.scene.transform import ViewTransform as RefView

        w, h = SIZES["v2"]
        ref_font = RefFont.open(str(FONT))
        want = np.asarray(RefRenderer(ref_font, ref_layout(ref_font, text), w, h,
                                      RasterEngine()).render_direct(
            RefView.init(ref_font.info.units_per_em, w, h)))
        pr = renderer(font, "v2", text=text)
        view = init_view(font, "v2")
        got = pr.render_direct(view)
        assert got.dtype == torch.uint8 and got.shape == (h, w) and not got.any()
        np.testing.assert_array_equal(got.numpy(), want)
        assert pr.render_direct(view, band=(8, 16)).shape == (16, w)


class TestAgainstOracle:
    @pytest.mark.parametrize("size", sorted(SIZES))
    def test_sampled_rows(self, font, port_windings, size):
        from fontrx.kernels import oracle

        w, h = SIZES[size]
        pr = renderer(font, size)
        q = page_ref.transform_segments(*pr.page_inputs(init_view(font, size))).numpy()
        rows = np.arange(0, h, 16)
        xs = np.arange(w).astype(f32)
        ys = (h - 1 - rows).astype(f32)
        want = oracle.winding_at(q, xs[None, :], ys[:, None], contract=False)
        np.testing.assert_array_equal(port_windings[size, 0].numpy()[rows], want)


# -- the kernel's row cull ------------------------------------------------------


class TestCull:
    ROWS = 256

    def cases(self, font):
        yield "ulp slivers", ulp_slivers(self.ROWS)
        yield "near lines", near_lines(self.ROWS)
        yield "on rows", on_rows(self.ROWS)
        for k, view in enumerate(zoomed_views(font, 480, self.ROWS)):
            yield f"zoomed page {k}", page_stream(font, 480, self.ROWS, view).numpy()

    def test_keeps_every_crossing(self, font):
        for name, q in self.cases(font):
            for page_w in (SIZES["v2"][0], SIZES["k7"][0]):  # both routes
                assert stray_crossings(q, self.ROWS - 1, self.ROWS, page_w) == 0, name
                # bands move the rows and the strips
                assert stray_crossings(q, self.ROWS - 1 - 40, 100, page_w) == 0, name
                assert stray_crossings(q, self.ROWS - 1 - 57, 199, page_w) == 0, name

    def test_cases_cross_outside_the_hull(self):
        """The slivers are what the margin is for: without it they cross."""
        for q in (ulp_slivers(self.ROWS), near_lines(self.ROWS)):
            q = torch.from_numpy(q)
            roots, _ = page_ref.row_roots(q, page_ref.row_coords(self.ROWS - 1, self.ROWS))
            cy = page_ref.row_coords(self.ROWS - 1, self.ROWS)
            ys = q[:, 1::2]
            outside = (cy[None] > ys.amax(1)[:, None]) | (cy[None] < ys.amin(1)[:, None])
            assert ((roots > 0) & outside).sum() > 0

    def test_margin_one_row_short_drops_crossings(self, monkeypatch):
        full = page_ref.margin
        monkeypatch.setattr(page_ref, "margin", lambda q, ymax: full(q, ymax) - 1.0)
        assert stray_crossings(ulp_slivers(self.ROWS), self.ROWS - 1, self.ROWS, 480) > 0

    def test_k7_margin_drops_near_line_crossings(self, monkeypatch):
        """A fixed 1 px margin around each segment (K7's around each chunk)
        would drop the near lines' strays that the page keeps; the port's
        margin widens for them."""
        monkeypatch.setattr(page_ref, "margin",
                            lambda q, ymax: torch.ones(len(q), dtype=torch.float64))
        assert stray_crossings(near_lines(self.ROWS), self.ROWS - 1, self.ROWS, 480) > 0

    def test_margin_by_hand(self):
        q = torch.tensor([[0, 10, 1, 5, 2, 0],        # a line: 1
                          [0, 0, 5, 40, 10, 0],       # a = -80: 1
                          [0, 200, 0, 150, 0, 100.0],  # a = 0 exactly: 1
                          near_lines(256)[0].tolist()], dtype=torch.float32)
        m = page_ref.margin(q, 255.0)
        assert m.tolist()[:3] == [1.0, 1.0, 1.0]
        assert m[3] > 256  # every row
        u, big = 2.0**-24, 255.0
        assert float(page_ref.margin(q[1:2], big)[0]) == max(
            1.0, 160 * big * big * u / (80 - 8 * big * u) + 32 * big * u)

    def test_page_rows_counts_real_pages(self, font):
        """The cull keeps a few percent of a page's pairs."""
        q = page_stream(font, 480, self.ROWS, init_view(font, "v2"))
        kept = int(page_ref.page_rows(q, self.ROWS - 1, self.ROWS, 480).sum())
        assert 0 < kept < 0.05 * q.shape[0] * self.ROWS


# -- the wrapper on the CPU -------------------------------------------------------


class TestWrapper:
    def test_cpu_tensor_runs_plain_version(self, font):
        inp = sliver_page(on_rows(64))
        before = page.launches
        out = page.direct_page(*inp, page_h=64, page_w=128, mode="winding")
        assert page.launches == before
        assert out.dtype == torch.int32 and out.shape == (64, 128)
        assert torch.equal(out, page_ref.direct_page(*inp, page_h=64, page_w=128,
                                                     mode="winding"))

    @pytest.mark.parametrize("case", ["dtype", "owner_dtype", "shape", "owner_shape",
                                      "offsets_shape", "contiguous", "s_px", "s_px_nan",
                                      "mode", "size"])
    def test_check_rejects_what_the_kernel_does_not_take(self, case):
        seg, idx, offs, s_px = sliver_page(on_rows(64))
        kw = dict(band_y0=0, page_h=64, page_w=64, out_h=64, mode="fill")
        bad = {
            "dtype": lambda: (seg.double(), idx, offs, s_px),
            "owner_dtype": lambda: (seg, idx.long(), offs, s_px),
            "shape": lambda: (seg[:, :2].contiguous(), idx, offs, s_px),
            "owner_shape": lambda: (seg, idx[:2], offs, s_px),
            "offsets_shape": lambda: (seg, idx, offs.reshape(2, 1), s_px),
            "contiguous": lambda: (seg.transpose(0, 1).contiguous().transpose(0, 1), idx, offs,
                                   s_px),
            "s_px": lambda: (seg, idx, offs, 0.0),
            "s_px_nan": lambda: (seg, idx, offs, float("nan")),
        }
        if case == "mode":
            kw["mode"] = "msaa"
        elif case == "size":
            kw["out_h"] = -1
        args = bad.get(case, lambda: (seg, idx, offs, s_px))()
        with pytest.raises((TypeError, ValueError)):
            page.check_inputs(*args, **kw)

    def test_check_wants_cuda_tensors(self):
        with pytest.raises(ValueError, match="CUDA"):
            page.check_inputs(*sliver_page(on_rows(64)), 0, 64, 64, 64, "fill")

    def test_no_quiet_fallback(self):
        """A tensor that is not on the CPU never goes to the plain version."""
        seg = torch.empty((4, 3, 2), device="meta")
        idx = torch.empty(4, dtype=torch.int32, device="meta")
        offs = torch.empty((1, 2), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            page.direct_page(seg, idx, offs, 1.0, page_h=8, page_w=8)

    def test_build_failure_raises(self, monkeypatch):
        def fail(name):
            raise RuntimeError(f"nvcc failed for {name}")

        monkeypatch.setattr(_build, "load", fail)
        seg, idx, offs, s_px = sliver_page(on_rows(64))
        before = page.launches
        with pytest.raises(RuntimeError, match="nvcc failed for page"):
            page.launch(seg, idx, offs, s_px, len(seg), 1, 63, 64, 64, "fill")
        assert page.launches == before

    def test_renderer_has_no_default_device(self, font):
        with pytest.raises(TypeError):
            PageRenderer(font, layout_text(font, "a"), 8, 8)

    def test_compaction_is_cached_per_layout(self, font):
        pr = renderer(font, "v2")
        first = pr.page_inputs(init_view(font, "v2"))
        second = pr.page_inputs(init_view(font, "v2").zoomed(1.0, (0.0, 0.0)))
        assert first[0] is second[0] and first[1] is second[1]
        slots, _ = pr.layout.instance_arrays()
        assert len(first[0]) == int(pr.layout.batch.seg_counts[slots].sum())


# -- the kernel on the card ---------------------------------------------------------


def winding_kernel_page(inputs, page_h, page_w, band_y0=0, out_h=None):
    """The same page from the winding kernel at batch 1 (``csrc/winding.cu``),
    which solves every (segment, row) pair: the page where no root strays."""
    flat = page_ref.transform_segments(*inputs)[None].contiguous()
    dev = flat.device
    return winding.winding_batch(
        flat, torch.zeros(1, dtype=torch.int32, device=dev),
        torch.full((1,), page_h - 1 - band_y0, dtype=torch.int32, device=dev), 1.0,
        height=page_h if out_h is None else out_h, width=page_w)[0]


@pytest.mark.requires_cuda
class TestKernelOnCard:
    def card_cases(self, font, cuda):
        """``(inputs, page_h, page_w, first_view)``: the slivers on both
        routes, and each page at each view."""
        for q in (ulp_slivers(256), near_lines(256), on_rows(256)):
            inputs = tuple(t.to(cuda) if torch.is_tensor(t) else t for t in sliver_page(q))
            for w in (400, 1100):
                yield inputs, 256, w, False
        for size in sorted(SIZES):
            w, h = SIZES[size]
            pr = renderer(font, size, cuda)
            for k, view in enumerate(views(font, size)):
                yield pr.page_inputs(view), h, w, k == 0

    def test_kernel_matches_plain_version_and_winding_kernel(self, font, cuda):
        for inputs, h, w, first_view in self.card_cases(font, cuda):
            before = page.launches
            got = page.direct_page(*inputs, page_h=h, page_w=w, mode="winding")
            torch.cuda.synchronize()
            assert page.launches == before + 1
            want = page_ref.direct_page(*inputs, page_h=h, page_w=w, mode="winding")
            assert torch.equal(got, want)
            for mode in ("fill", "gray"):
                assert torch.equal(page.direct_page(*inputs, page_h=h, page_w=w, mode=mode),
                                   page_ref.finish(want, mode))
            band = page.direct_page(*inputs, 40, page_h=h, page_w=w, out_h=100, mode="winding")
            assert torch.equal(band, page_ref.direct_page(*inputs, 40, page_h=h, page_w=w,
                                                          out_h=100, mode="winding"))
            if first_view:
                assert torch.equal(got, winding_kernel_page(inputs, h, w))
                assert torch.equal(band, winding_kernel_page(inputs, h, w, 40, 100))

    @pytest.mark.parametrize("page_w", [1, 31, 33, 255, 257, 362, 1100])
    def test_widths_rows_and_spans(self, cuda, page_w):
        """Widths around the scan's words and steps and both routes, a
        one-row band, a band inside the page, a segment that crosses one
        row and one that crosses more than 32."""
        q = np.concatenate([ulp_slivers(64), on_rows(64), [
            [5.0, 9.6, 6.0, 10.0, 7.0, 10.4],     # crosses the row at y = 10 only
            [3.0, 2.0, 20.0, 30.0, 8.0, 60.0],    # 58 rows
            [0.5, 63.5, 400.0, 30.0, 0.5, 0.5],   # across the page
        ]]).astype(f32)
        inputs = tuple(t.to(cuda) if torch.is_tensor(t) else t for t in sliver_page(q))
        for y0, out_h in ((0, 64), (0, 1), (40, 17), (63, 1)):
            for mode in ("winding", "fill", "gray"):
                got = page.direct_page(*inputs, y0, page_h=64, page_w=page_w, out_h=out_h,
                                       mode=mode)
                want = page_ref.direct_page(*inputs, y0, page_h=64, page_w=page_w,
                                            out_h=out_h, mode=mode)
                assert got.shape == (out_h, page_w) and torch.equal(got, want)

    @pytest.mark.parametrize("page_w", [33, 1100])
    def test_no_segments(self, cuda, page_w):
        seg = torch.zeros((0, 3, 2), device=cuda)
        idx = torch.zeros(0, dtype=torch.int32, device=cuda)
        offs = torch.zeros((1, 2), device=cuda)
        before = page.launches
        got = page.direct_page(seg, idx, offs, 1.0, page_h=20, page_w=page_w, mode="winding")
        torch.cuda.synchronize()
        assert page.launches == before + 1
        assert got.shape == (20, page_w) and not got.any()

    def test_render_direct_launches_once(self, font, cuda):
        pr = renderer(font, "k7", cuda)
        view = init_view(font, "k7")
        before = page.launches
        full = pr.render_direct(view)
        band = pr.render_direct(view, band=BAND)
        torch.cuda.synchronize()
        assert page.launches == before + 2
        assert full.device.type == "cuda" and full.dtype == torch.uint8
        assert torch.equal(band, full[BAND[0] : BAND[0] + BAND[1]])
        assert torch.equal(full.cpu(), renderer(font, "k7").render_direct(view))

    def test_wrapper_rejects_bad_inputs(self, cuda):
        seg, idx, offs, _ = (t.to(cuda) if torch.is_tensor(t) else t
                             for t in sliver_page(on_rows(64)))
        before = page.launches
        with pytest.raises(TypeError):
            page.direct_page(seg.double(), idx, offs, 1.0, page_h=8, page_w=8)
        with pytest.raises(ValueError):
            page.direct_page(seg, idx[:1], offs, 1.0, page_h=8, page_w=8)
        with pytest.raises(ValueError):
            page.direct_page(seg, idx, offs, 0.0, page_h=8, page_w=8)
        with pytest.raises(ValueError):
            page.direct_page(seg, idx, offs.cpu(), 1.0, page_h=8, page_w=8)
        assert page.launches == before

    def test_build_failure_raises(self, cuda, monkeypatch):
        def fail(name):
            raise RuntimeError(f"nvcc failed for {name}")

        monkeypatch.setattr(_build, "load", fail)
        inputs = tuple(t.to(cuda) if torch.is_tensor(t) else t for t in sliver_page(on_rows(64)))
        before = page.launches
        with pytest.raises(RuntimeError, match="nvcc failed"):
            page.direct_page(*inputs, page_h=64, page_w=64)
        assert page.launches == before

    def test_failed_launch_raises(self, cuda, monkeypatch):
        """The kernel's entry refuses a bad mode; the wrapper raises and counts
        no launch."""
        lib = _build.load("page")

        class BadMode:
            @staticmethod
            def page(*args):
                args = list(args)
                args[9] = 7  # mode
                return lib.page(*args)

        monkeypatch.setattr(_build, "load", lambda name: BadMode)
        inputs = tuple(t.to(cuda) if torch.is_tensor(t) else t for t in sliver_page(on_rows(64)))
        before = page.launches
        with pytest.raises(RuntimeError, match="page kernel launch failed"):
            page.direct_page(*inputs, page_h=64, page_w=64)
        assert page.launches == before
