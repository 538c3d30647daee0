"""fontrx_torch k x k coverage: the plain PyTorch version against the NumPy
oracle and the JAX package, the reciprocal rounding rule, the wrapper's CPU
route and the engine, and the CUDA kernel against the plain version on the
card.

Exactness rules:
- at k = 1 coverage is the fill ``(w != 0)`` of ``winding_ref``, bit for bit;
- ``coverage_ref`` is the oracle's (``contract=False``) nonzero samples
  counted over the k x k lattice, times ``float32(1 / k^2)``, bit for bit;
- against the JAX package on the CPU a pixel may differ only where one of its
  samples is a tie: a sample where the oracle's contract=True and
  contract=False windings disagree (XLA:CPU contracts the x-polynomial, the
  port does not).

The module imports JAX only inside the tests that compare with it, so the
card's tests also run where there is no JAX:
``python -m pytest --noconftest -m requires_cuda tests/test_torch_coverage.py``.
"""

import pathlib

import numpy as np
import pytest
import torch

from benchmarks.cjk import UPEM, synthetic_strokes
from fontrx.kernels import oracle
from fontrx_torch.engine.raster import RasterEngine
from fontrx_torch.font.font import Font
from fontrx_torch.kernels import _build, coverage, coverage_ref, page_ref, winding_ref
from fontrx_torch.kernels.grid import RasterGrid
from fontrx_torch.pack.segments import glyph_segments, pack_glyphs

FONT = pathlib.Path(__file__).resolve().parents[1] / "fontrx_torch" / "data" / "DejaVuSans.ttf"
f32 = np.float32


@pytest.fixture(scope="module")
def font():
    return Font.open(FONT)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def glyph_batch(font, chars, size, tile):
    batch = pack_glyphs([font.get_glyph(c)[0] for c in chars])
    grids = [RasterGrid.fixed_tile(tuple(b), size, font.info.units_per_em, tile)
             for b in batch.boxes]
    min_x = np.array([g.min_x for g in grids], np.int32)
    max_y = np.array([g.max_y for g in grids], np.int32)
    return batch.segments, min_x, max_y, f32(grids[0].scale)


def synthetic_batch(size):
    rng = np.random.default_rng(5)
    segs = np.stack([synthetic_strokes(rng, 300) for _ in range(2)])
    return segs, np.zeros(2, np.int32), np.full(2, size - 1, np.int32), f32(size / UPEM)


def tensors(segs, min_x, max_y, scale, device="cpu"):
    return (torch.from_numpy(np.ascontiguousarray(segs, np.float32)).to(device),
            torch.from_numpy(np.asarray(min_x, np.int32)).to(device),
            torch.from_numpy(np.asarray(max_y, np.int32)).to(device), float(scale))


def ref(segs, min_x, max_y, scale, h, w, k):
    return coverage_ref.coverage_batch(
        *tensors(segs, min_x, max_y, scale), height=h, width=w, samples=k).numpy()


def sub_coords(min_x, max_y, scale, h, w, off):
    """Oracle sample coordinates at one lattice offset, in the kernels' op
    order: int add, then the offset, then one f32 divide."""
    xs = ((min_x + np.arange(w)).astype(f32) + f32(off[0])) / f32(scale)
    ys = ((max_y - np.arange(h)).astype(f32) + f32(off[1])) / f32(scale)
    return xs[None, :], ys[:, None]


def oracle_counts(seg, min_x, max_y, scale, h, w, k):
    """Per pixel: the oracle's (contract=False) nonzero samples, and whether
    any sample is a tie (contract=True disagrees)."""
    count = np.zeros((h, w), np.int32)
    tie = np.zeros((h, w), bool)
    for off in coverage_ref.sample_offsets(k):
        cx, cy = sub_coords(min_x, max_y, scale, h, w, off)
        strict = oracle.winding_at(seg, cx, cy, contract=False)
        count += strict != 0
        tie |= oracle.winding_at(seg, cx, cy, contract=True) != strict
    return count, tie


def assert_ties_only(port, other, segs, min_x, max_y, scale, h, w, k):
    for i in range(len(segs)):
        diff = port[i] != other[i]
        if diff.any():
            _, tie = oracle_counts(segs[i], min_x[i], max_y[i], scale, h, w, k)
            assert not (diff & ~tie).any(), f"glyph {i}: non-tie pixels differ"


def wedge_batch():
    """A thin wedge with irrational-looking slopes across a 24 x 24 raster:
    its edge pixels take most sample counts 0..25 at k = 5."""
    tri = np.array([[0, 0], [1531, 2011], [1873, 97]], np.float32)
    segs = np.zeros((1, 4, 3, 2), np.float32)
    for i in range(3):
        p0, p2 = tri[i], tri[(i + 1) % 3]
        segs[0, i] = [p0, (p0 + p2) / 2, p2]
    return segs, np.zeros(1, np.int32), np.full(1, 23, np.int32), f32(24 / 2048)


class TestRef:
    @pytest.mark.parametrize("which", ["glyphs", "strokes"])
    def test_k1_is_the_fill(self, font, which):
        args = glyph_batch(font, "AQg@&", 48, 48) if which == "glyphs" else synthetic_batch(40)
        h = w = 48 if which == "glyphs" else 40
        fill = winding_ref.winding_batch(*tensors(*args), height=h, width=w) != 0
        np.testing.assert_array_equal(ref(*args, h, w, 1), fill.to(torch.float32).numpy())

    @pytest.mark.parametrize("k", [2, 4])
    @pytest.mark.parametrize("chars", ["AQ", "@é", "g&"])
    def test_equals_oracle(self, font, chars, k):
        segs, min_x, max_y, scale = glyph_batch(font, chars, 40, 40)
        out = ref(segs, min_x, max_y, scale, 40, 40, k)
        for i in range(len(segs)):
            count, _ = oracle_counts(segs[i], min_x[i], max_y[i], scale, 40, 40, k)
            np.testing.assert_array_equal(out[i], count.astype(f32) * f32(1 / (k * k)))
            assert ((out[i] > 0) & (out[i] < 1)).any()  # the edges are antialiased

    @pytest.mark.parametrize("k", [1, 2, 3, 5, 7])
    def test_sample_offsets_equal_reference(self, k):
        from fontrx.kernels.coverage import sample_offsets

        got = coverage_ref.sample_offsets(k)
        assert got.dtype == np.float32 and got.shape == (k * k, 2)
        np.testing.assert_array_equal(got, sample_offsets(k))
        np.testing.assert_array_equal(got[:k, 0], got[0::k, 1])  # ox varies fastest

    def test_reciprocal_rule_at_k5(self):
        """count * f32(1/25), not count / 25: they differ at 7 of the 26
        counts, and the JAX package rounds the first way."""
        from fontrx.kernels.coverage import coverage_batch as jax_coverage

        import jax.numpy as jnp

        counts = np.arange(26)
        product = counts.astype(f32) * f32(1 / 25)
        quotient = (counts / 25).astype(f32)
        differing = set(counts[product != quotient].tolist())
        assert len(differing) == 7

        segs, min_x, max_y, scale = wedge_batch()
        out = ref(segs, min_x, max_y, scale, 24, 24, 5)[0]
        count, tie = oracle_counts(segs[0], min_x[0], max_y[0], scale, 24, 24, 5)
        at = np.isin(count, list(differing))
        assert at.sum() >= 3 and len(set(count[at].tolist())) >= 2  # not vacuous
        np.testing.assert_array_equal(out, count.astype(f32) * f32(1 / 25))
        assert (out[at] != (count[at] / 25).astype(f32)).all()

        jax_out = np.asarray(jax_coverage(
            jnp.asarray(segs), jnp.asarray(min_x), jnp.asarray(max_y), jnp.float32(scale),
            height=24, width=24, samples=5))[0]
        assert not ((out != jax_out) & ~tie).any()
        assert (out[at & ~tie] == jax_out[at & ~tie]).all()

    def test_coverage_to_gray(self):
        from fontrx.kernels.coverage import coverage_to_gray

        rng = np.random.default_rng(2)
        cov = rng.random((2, 9, 11)).astype(f32)
        cov[0, 0, :6] = [0.0, 1.0, 0.5 / 255, 1.5 / 255, 2.5 / 255, 1.25]
        port = coverage_ref.coverage_to_gray(torch.from_numpy(cov))
        assert port.dtype == torch.uint8
        np.testing.assert_array_equal(port.numpy(), np.asarray(coverage_to_gray(cov)))

    def test_samples_below_one_raise(self):
        with pytest.raises(ValueError, match="samples"):
            coverage_ref.coverage_batch(*tensors(*wedge_batch()), height=4, width=4, samples=0)


class TestRefVsJax:
    def test_vs_coverage_jnp(self, font):
        import jax.numpy as jnp

        from fontrx.kernels.coverage import coverage_batch

        for (segs, min_x, max_y, scale), h in ((glyph_batch(font, "AQg@", 64, 64), 64),
                                               (synthetic_batch(48), 48)):
            jax_out = np.asarray(coverage_batch(
                jnp.asarray(segs), jnp.asarray(min_x), jnp.asarray(max_y),
                jnp.float32(scale), height=h, width=h, samples=2))
            port = ref(segs, min_x, max_y, scale, h, h, 2)
            assert_ties_only(port, jax_out, segs, min_x, max_y, scale, h, h, 2)

    def test_vs_pallas_interpret(self, font):
        """K9, run as the JAX package's tests run it: 'B' at 96 px on a
        128 x 128 grid, 2 x 2 samples."""
        import jax.numpy as jnp

        from fontrx.kernels.coverage_pallas import coverage_pallas_batch

        g, _ = font.get_glyph("B")
        segs = glyph_segments(g)[None]
        grid = RasterGrid.for_glyph_box(
            (g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max), 96, 2048).padded(128, 128)
        assert (grid.height, grid.width) == (128, 128)
        min_x, max_y = np.array([grid.min_x], np.int32), np.array([grid.max_y], np.int32)
        jax_out = np.asarray(coverage_pallas_batch(
            jnp.asarray(segs), jnp.asarray(min_x), jnp.asarray(max_y), jnp.float32(grid.scale),
            height=128, width=128, samples=2, interpret=True))
        port = ref(segs, min_x, max_y, grid.scale, 128, 128, 2)
        assert_ties_only(port, jax_out, segs, min_x, max_y, grid.scale, 128, 128, 2)

    def test_k9_lattice_at_k3(self):
        """K9 rounds its sample offsets from float64, ``f32((i + 0.5)/k -
        0.5)``; the port and the other JAX routes compute them in float32
        (``sample_offsets``). At k = 3 the first differs by an ulp:
        -0.33333334 against -0.33333331. A rectangle whose left edge lies on
        K9's value (its edges are exact lines: the midpoint control points
        round to no curvature), on a 128 x 128 grid at ``min_x = 0`` and scale 1, puts
        column 0's first sub-column on the edge for K9 (outside) and just
        right of it for the port (inside). The oracle at ``sample_offsets``
        sides with the port on every pixel; at K9's lattice it gives K9's
        result. So the pixels that differ are a divergence inside the
        reference, not a port fault."""
        import jax.numpy as jnp

        from fontrx.kernels.coverage_pallas import coverage_pallas_batch

        k9_offsets = np.array([(i + 0.5) / 3 - 0.5 for i in range(3)]).astype(f32)
        port_offsets = coverage_ref.sample_offsets(3)[:3, 0]
        assert k9_offsets[0] != port_offsets[0] and k9_offsets[0] < port_offsets[0]
        x0 = k9_offsets[0]
        corners = [(x0, 10.25), (60.0, 10.25), (60.0, 100.25), (x0, 100.25)]
        segs = np.zeros((1, 4, 3, 2), f32)
        for i in range(4):
            p0, p2 = np.array(corners[i], f32), np.array(corners[(i + 1) % 4], f32)
            segs[0, i] = [p0, (p0 + p2) / 2, p2]
        min_x, max_y, scale = np.zeros(1, np.int32), np.full(1, 127, np.int32), f32(1.0)

        port = ref(segs, min_x, max_y, scale, 128, 128, 3)[0]
        k9 = np.asarray(coverage_pallas_batch(
            jnp.asarray(segs), jnp.asarray(min_x), jnp.asarray(max_y), jnp.float32(scale),
            height=128, width=128, samples=3, interpret=True))[0]
        count, _ = oracle_counts(segs[0], 0, 127, scale, 128, 128, 3)
        np.testing.assert_array_equal(port, count.astype(f32) * f32(1 / 9))

        k9_count = np.zeros((128, 128), np.int32)
        for oy in k9_offsets:
            for ox in k9_offsets:
                cx, cy = sub_coords(0, 127, scale, 128, 128, (ox, oy))
                k9_count += oracle.winding_at(segs[0], cx, cy, contract=False) != 0
        np.testing.assert_array_equal(k9, k9_count.astype(f32) * f32(1 / 9))

        # column 0, the rows 27..117 that the rectangle's sub-rows reach:
        # there K9 drops the first sub-column's samples
        differ = port != k9
        assert differ.sum() == 91 and not differ[:, 1:].any()
        assert (port[differ] > k9[differ]).all()

    def test_engine_vs_jax_engine(self, font):
        """The slice's entry point: ``RasterEngine.coverage_batch`` then
        ``coverage_to_gray``, against the JAX package's."""
        from fontrx.engine.raster import RasterEngine as JaxEngine
        from fontrx.kernels.coverage import coverage_to_gray

        segs, min_x, max_y, scale = glyph_batch(font, "Wé8", 32, 36)
        engine = RasterEngine(device="cpu")
        cov = engine.coverage_batch(segs, min_x, max_y, scale, height=36, width=36)
        jengine = JaxEngine(backend="jnp")
        jcov = jengine.coverage_batch(segs, min_x, max_y, scale, height=36, width=36)
        assert cov.dtype == torch.float32 and tuple(cov.shape) == (3, 36, 36)
        assert_ties_only(cov.numpy(), np.asarray(jcov), segs, min_x, max_y, scale, 36, 36, 2)
        gray = engine.coverage_to_gray(cov).numpy()
        jgray = np.asarray(coverage_to_gray(jcov))
        assert_ties_only(gray, jgray, segs, min_x, max_y, scale, 36, 36, 2)


# -- the CUDA kernel's row cull, in em units -------------------------------------

CULL_SIZE = 64              # px: the CJK atlas's tile
CULL_SCALE = f32(CULL_SIZE / 2048)
CULL_MAX_Y = CULL_SIZE - 1


@pytest.fixture
def one_torch_thread():
    """Small tensors: torch on one thread, so parallel test workers do not
    spin against each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def sub_rows(k, h=CULL_SIZE, max_y=CULL_MAX_Y, scale=CULL_SCALE):
    """The em-space y of every sub-row the kernel samples: float32
    ``((f32)(max_y - y) + o[ky]) / scale`` for rows ``y < h``, ``ky < k``."""
    oys = coverage_ref.sample_offsets(k)[::k, 1]
    ys = (max_y - np.arange(h)).astype(f32)
    return np.sort((ys[:, None] + oys[None, :]).ravel() / f32(scale))[::-1].copy()


def em_slivers(k, seed=0, n=96):
    """Em-space quadratics whose control hull's top (or bottom) lies one ulp
    below (above) a sample sub-row."""
    rng = np.random.default_rng(seed)
    cy = sub_rows(k)
    out = []
    for i in range(n):
        y0 = cy[rng.integers(8 * k, len(cy) - 8 * k)]
        span = f32(rng.uniform(16.0, 1900.0))
        if i % 2:
            edge = np.nextafter(y0, f32(-np.inf))
            far = f32(edge - span)
        else:
            edge = np.nextafter(y0, f32(np.inf))
            far = f32(edge + span)
        mid = f32(rng.uniform(min(edge, far), max(edge, far)))
        p0, p2 = (edge, far) if rng.random() < 0.5 else (far, edge)
        x = rng.uniform(0, 2048, 3).astype(f32)
        out.append([x[0], p0, x[1], mid, x[2], p2])
    return np.array(out, f32)


def em_near_lines():
    """Em-space lines whose control point sits a few ulps off their midpoint:
    ``a`` is tiny and the rounded roots stray far from the hull."""
    out = []
    for p0 in (1800.0, 1500.5, 1000.25, 300.0):
        p2 = p0 - 250.0
        for j in (1, 2, 3, 5, 8):
            for sgn in (1, -1):
                p1 = f32((p0 + p2) / 2) + f32(sgn * j * 2.0**-13)
                out.append([100.0, p0, 120.0, p1, 140.0, p2])
    return np.array(out, f32)


def em_on_rows(k):
    """Segments lying exactly on a sub-row, lines and curves ending on one,
    and a curve whose vertex touches one."""
    cy = sub_rows(k)
    y = cy[len(cy) // 2]
    d = f32(5 / CULL_SCALE)
    return np.array([
        [0, y, 500, y, 1000, y],
        [0, y, 50, y - d, 100, y - 2 * d],
        [0, y - 2 * d, 50, y - d, 100, y],
        [0, y - d, 50, y + d, 100, y - d],
        [0, y, 50, y + d, 100, y],
    ], f32)


def kept_pairs(q, cy):
    """The kernel's cull, bool ``[S, R]``: sub-row ``cy[j]`` within
    ``page_ref.margin`` of segment ``q``'s control-hull y-range, the margin
    taken at ``|cy[j]|`` alone (the least bound of ``|y|`` the proof allows;
    the kernel takes its block's largest, a wider margin)."""
    q = torch.as_tensor(q)
    cy = torch.as_tensor(cy).double()
    ys = q[:, 1::2].double()
    lo, hi = ys.amin(1), ys.amax(1)
    m = torch.stack([page_ref.margin(q, float(abs(y))) for y in cy], 1)
    return (cy[None] >= lo[:, None] - m) & (cy[None] <= hi[:, None] + m)


def dropped_crossings(q, k):
    """(segment, sub-row) pairs with a crossing that the cull drops."""
    cy = torch.from_numpy(sub_rows(k))
    roots, _ = page_ref.row_roots(torch.as_tensor(q), cy)
    return int(((roots > 0) & ~kept_pairs(q, cy)).sum())


@pytest.mark.parametrize("k", [1, 2, 3])
class TestCull:
    def cases(self, font, k):
        yield "ulp slivers", em_slivers(k)
        yield "near lines", em_near_lines()
        yield "on rows", em_on_rows(k)
        segs, *_ = glyph_batch(font, "AQg@&%Wb", CULL_SIZE, CULL_SIZE)
        yield "glyphs", segs.reshape(-1, 6)

    def test_keeps_every_crossing(self, font, k, one_torch_thread):
        for name, q in self.cases(font, k):
            assert dropped_crossings(q, k) == 0, name

    def test_cases_cross_outside_the_hull(self, k, one_torch_thread):
        """The slivers and near lines are what the margin is for: without it
        they cross."""
        cy = torch.from_numpy(sub_rows(k))
        for q in (em_slivers(k), em_near_lines()):
            q = torch.from_numpy(q)
            roots, _ = page_ref.row_roots(q, cy)
            ys = q[:, 1::2]
            outside = (cy[None] > ys.amax(1)[:, None]) | (cy[None] < ys.amin(1)[:, None])
            assert ((roots > 0) & outside).sum() > 0

    def test_margin_one_unit_short_drops_crossings(self, monkeypatch, k, one_torch_thread):
        full = page_ref.margin
        monkeypatch.setattr(page_ref, "margin", lambda q, ymax: full(q, ymax) - 1.0)
        assert dropped_crossings(em_slivers(k), k) > 0

    def test_fixed_margin_drops_near_line_crossings(self, monkeypatch, k, one_torch_thread):
        monkeypatch.setattr(page_ref, "margin",
                            lambda q, ymax: torch.ones(len(q), dtype=torch.float64))
        assert dropped_crossings(em_near_lines(), k) > 0

    def test_sub_rows_fall(self, k):
        """The kernel's sub-row order: cy non-increasing, so a segment's kept
        sub-rows are a run."""
        cy = sub_rows(k)
        oys = coverage_ref.sample_offsets(k)[::k, 1]
        ys = (CULL_MAX_Y - np.arange(CULL_SIZE)).astype(f32)
        kernel_order = ((ys[:, None] + oys[None, ::-1]).ravel() / CULL_SCALE).astype(f32)
        np.testing.assert_array_equal(kernel_order, cy)


def sliver_batch(k):
    """The cull's cases as a coverage batch on the 64 px tile."""
    qs = [em_slivers(k), em_near_lines(), em_on_rows(k)]
    n = max(len(q) for q in qs)
    segs = np.zeros((len(qs), n, 3, 2), f32)
    for i, q in enumerate(qs):
        segs[i, : len(q)] = q.reshape(-1, 3, 2)
    anchors = np.zeros(len(qs), np.int32), np.full(len(qs), CULL_MAX_Y, np.int32)
    return segs, *anchors, CULL_SCALE


class TestWrapper:
    def test_cpu_tensor_runs_plain_version(self, font):
        args = glyph_batch(font, "Rx", 40, 48)
        before = coverage.launches
        out = coverage.coverage_batch(*tensors(*args), height=48, width=48, samples=3)
        assert coverage.launches == before
        assert out.dtype == torch.float32 and out.device.type == "cpu"
        np.testing.assert_array_equal(out.numpy(), ref(*args, 48, 48, 3))

    def test_cpu_engine_never_launches(self, font):
        before = coverage.launches
        RasterEngine(device="cpu").coverage_batch(*glyph_batch(font, "k", 24, 24),
                                                  height=24, width=24, samples=2)
        assert coverage.launches == before


# -- the kernel's launch plan: coverage.cu's make_plan, transcribed ---------

SMEM_LIMIT, SMEM_TARGET = 227 * 1024, 45 * 1024
THREADS, WARPS, SMALL_CHUNK, MAX_ROWS, MAX_SUB_ROWS = 256, 8, 32, 16, 256


def block_smem(chunk, k, w, wp, rows, group):
    sub = rows * group
    return (sub * k * wp * 4 + k * w * 4 + sub * 4 + chunk * 6 * 4 + WARPS * 4
            + chunk * sub * 2)


def launch_plan(k, h, w):
    """(cols, chunk, rows, group, Wp, shared bytes) of the launch that
    coverage() makes, None where no block fits. The card holds it to the C
    (``TestKernelOnCard.test_plan_matches_transcription``)."""
    wp = (w + 3) // 4 * 4
    group = min(k, MAX_SUB_ROWS)
    while group > 0 and block_smem(THREADS, k, w, wp, 1, group) > SMEM_LIMIT:
        group -= 1
    if group > 0:
        rows = 1
        while (rows < min(MAX_ROWS, h) and (rows + 1) * group <= MAX_SUB_ROWS
               and block_smem(THREADS, k, w, wp, rows + 1, group) <= SMEM_TARGET):
            rows += 1
        return (4 if w >= 128 else 2, THREADS, rows, group, wp,
                block_smem(THREADS, k, w, wp, rows, group))
    smem = block_smem(SMALL_CHUNK, k, w, w, 1, 1)
    return (1, SMALL_CHUNK, 1, 1, w, smem) if smem <= SMEM_LIMIT else None


def plan_path(plan, k):
    if plan[1] == SMALL_CHUNK:
        return "least"  # one row, a chunk of 32, planes of exactly W cells
    return "passes" if plan[3] < k else "all"


WIDTHS = [
    (2, 29, 37, "all"),        # a width that is a multiple of nothing
    (3, 5, 129, "all"),        # four columns a lane, a partial step
    (4, 3, 4000, "passes"),    # a row's 16 planes do not fit: the sub-rows in passes
    (28, 2, 1010, "least"),    # not one offset fits beside a full chunk
]


# the colour path's batches (fontrx_torch.engine.colorglyphs): many short
# (glyph, layer) rows on one square tile, k = 2; the command line's tile is
# round(size), the session's a power of two from 128 to 2048
COLOR_PLANS = [
    (64, (2, 256, 16, 2, 64, 39584)),
    (128, (4, 256, 12, 2, 128, 44160)),
    (256, (4, 256, 7, 2, 256, 44120)),
    (2048, (4, 256, 1, 2, 2048, 56360)),
]


class TestLaunchPlan:
    @pytest.mark.parametrize("tile,plan", COLOR_PLANS)
    def test_colour_tiles(self, tile, plan):
        """Every sub-row of a block in one pass: 16 rows a block at 64 px,
        12 at 128, one at 2048."""
        assert launch_plan(2, tile, tile) == plan
        assert plan_path(plan, 2) == "all"

    @pytest.mark.parametrize("k,h,w,path", WIDTHS)
    def test_widths_take_their_path(self, k, h, w, path):
        assert plan_path(launch_plan(k, h, w), k) == path

    def test_full_chunk_just_below_the_least_block(self):
        """k = 28 at W = 1003 still fits a full chunk, one offset a pass: the
        least block's case needs a wider row."""
        assert launch_plan(28, 2, 1003)[1:4] == (THREADS, 1, 1)

    @pytest.mark.parametrize("k", [1, 2, 4, 16, 28, 64])
    def test_serves_every_width_the_first_port_served(self, k):
        for w in range(1, 16385, 7):
            first_port = 64 * 6 * 4 + k * w * 4 + 4 + k * (w + 1) * 4 + w * 4  # one row
            if first_port <= SMEM_LIMIT:
                assert launch_plan(k, 1, w) is not None, w

    def test_overflow_has_no_plan(self):
        assert launch_plan(4, 2, 16384) is None


def card_plan(k, h, w):
    """coverage_plan() of the built kernel, None where no block fits."""
    plan = np.zeros(6, np.int32)
    err = _build.load("coverage").coverage_plan(k, h, w, plan.ctypes.data)
    return None if err else tuple(int(v) for v in plan)


@pytest.mark.requires_cuda
class TestKernelOnCard:
    @pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
    @pytest.mark.parametrize("size,tile", [(256, 256), (64, 64), (40, 48)])
    def test_kernel_matches_ref(self, cuda, font, k, size, tile):
        for batch in (glyph_batch(font, "AQg@&%Wb", size, tile), synthetic_batch(tile)):
            args = tensors(*batch, device=cuda)
            before = coverage.launches
            out = coverage.coverage_batch(*args, height=tile, width=tile, samples=k)
            torch.cuda.synchronize()
            assert coverage.launches == before + 1
            want = coverage_ref.coverage_batch(*args, height=tile, width=tile, samples=k)
            assert out.dtype == torch.float32 and torch.equal(out, want)

    def test_kernel_matches_oracle(self, cuda, font):
        segs, min_x, max_y, scale = glyph_batch(font, "Q&", 96, 96)
        out = coverage.coverage_batch(*tensors(segs, min_x, max_y, scale, cuda), height=96,
                                      width=96, samples=2).cpu().numpy()
        for i in range(len(segs)):
            count, _ = oracle_counts(segs[i], min_x[i], max_y[i], scale, 96, 96, 2)
            np.testing.assert_array_equal(out[i], count.astype(f32) * f32(0.25))

    def test_engine_on_card(self, cuda, font):
        segs, min_x, max_y, scale = glyph_batch(font, "a@", 64, 64)
        before = coverage.launches
        cov = RasterEngine(device=cuda).coverage_batch(segs, min_x, max_y, scale,
                                                       height=64, width=64, samples=2)
        assert coverage.launches == before + 1 and cov.device.type == "cuda"
        np.testing.assert_array_equal(cov.cpu().numpy(), ref(segs, min_x, max_y, scale,
                                                             64, 64, 2))

    @pytest.mark.parametrize("k", [2, 3])
    def test_slivers_and_near_lines(self, cuda, k):
        """The row cull's hard cases: crossings one ulp outside a hull and
        strays of nearly straight curves."""
        args = tensors(*sliver_batch(k), device=cuda)
        out = coverage.coverage_batch(*args, height=CULL_SIZE, width=CULL_SIZE, samples=k)
        want = coverage_ref.coverage_batch(*args, height=CULL_SIZE, width=CULL_SIZE, samples=k)
        assert torch.equal(out, want) and bool((out > 0).any())

    @pytest.mark.parametrize("k,h,w,path", WIDTHS)
    def test_widths(self, cuda, font, k, h, w, path):
        assert plan_path(card_plan(k, h, w), k) == path
        segs, min_x, max_y, scale = glyph_batch(font, "AQ", 64, 64)
        max_y = max_y - 30  # rows through the middle of the glyphs
        min_x = min_x - w // 2
        args = tensors(segs, min_x, max_y, scale, cuda)
        before = coverage.launches
        out = coverage.coverage_batch(*args, height=h, width=w, samples=k)
        torch.cuda.synchronize()
        assert coverage.launches == before + 1
        want = coverage_ref.coverage_batch(*args, height=h, width=w, samples=k)
        assert torch.equal(out, want) and bool(((out > 0) & (out < 1)).any())

    @pytest.mark.parametrize("tile,plan", COLOR_PLANS)
    def test_colour_batch(self, cuda, font, tile, plan):
        """A colour-shaped batch: 7 short rows sharing one grid (two layers of
        each of three glyphs and one more), on the plan the CPU asserts."""
        assert card_plan(2, tile, tile) == plan
        segs, min_x, max_y, scale = glyph_batch(font, "OIl.-o|", tile * 0.8, tile)
        min_x[:], max_y[:] = min_x[0], max_y[0]
        args = tensors(segs, min_x, max_y, scale, cuda)
        before = coverage.launches
        out = coverage.coverage_batch(*args, height=tile, width=tile, samples=2)
        torch.cuda.synchronize()
        assert coverage.launches == before + 1
        want = coverage_ref.coverage_batch(*args, height=tile, width=tile, samples=2)
        assert torch.equal(out, want) and bool(((out > 0) & (out < 1)).any())

    def test_plan_matches_transcription(self, cuda):
        for k in (1, 2, 3, 4, 5, 8, 16, 28, 64, 300):
            for h in (1, 7, 64):
                for w in (1, 37, 127, 128, 129, 1003, 1010, 4000, 8000, 16384):
                    assert card_plan(k, h, w) == launch_plan(k, h, w), (k, h, w)

    def test_shared_memory_overflow_raises(self, cuda):
        segs = torch.zeros((1, 4, 3, 2), device=cuda)
        anchors = torch.zeros(1, dtype=torch.int32, device=cuda)
        before = coverage.launches
        with pytest.raises(RuntimeError, match="coverage kernel launch failed"):
            coverage.coverage_batch(segs, anchors, anchors, 1.0, height=2, width=16384,
                                    samples=4)
        assert coverage.launches == before

    def test_wrapper_rejects_bad_inputs(self, cuda):
        segs = torch.zeros((2, 4, 3, 2), device=cuda)
        anchors = torch.zeros(2, dtype=torch.int32, device=cuda)
        with pytest.raises(TypeError):
            coverage.coverage_batch(segs.double(), anchors, anchors, 1.0, height=8, width=8)
        with pytest.raises(ValueError):
            coverage.coverage_batch(segs, anchors[:1], anchors, 1.0, height=8, width=8)
        with pytest.raises(ValueError):
            coverage.coverage_batch(segs, anchors, anchors, 0.0, height=8, width=8)
        with pytest.raises(ValueError):
            coverage.coverage_batch(segs, anchors, anchors, 1.0, height=8, width=8, samples=0)
