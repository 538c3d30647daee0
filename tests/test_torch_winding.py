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
from fontrx_torch.kernels import page_ref, winding, winding_ref
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


# -- the kernel's row cull (csrc/winding.cu), in em units ----------------------

f32 = np.float32
CULL_SIZE = 64                   # px: the CJK atlas's tile
CULL_SCALE = f32(CULL_SIZE / UPEM)
CULL_MAX_Y = CULL_SIZE - 1
# the sample offsets the paths pass: 0, K4's, the pack's margin (|oy| <= 1)
CULL_OFFSETS = [0.0, 0.25, -0.25, 1 / 3, -1 / 3, 1.0, -1.0]


@pytest.fixture
def one_torch_thread():
    """Small tensors: torch on one thread, so parallel test workers do not
    spin against each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def row_ys(max_y, rows, oy, scale=CULL_SCALE):
    """The em-space y of rows ``0..rows-1`` as the kernel computes them:
    float32 ``((f32)(max_y - r) + oy) / scale``, falling with the row."""
    return ((max_y - np.arange(rows)).astype(f32) + f32(oy)) / f32(scale)


def em_slivers(cy, seed=0, n=64):
    """Em-space quadratics whose control hull's top (or bottom) lies one ulp
    below (above) a sample row ``cy``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        y0 = cy[rng.integers(4, len(cy) - 4)]
        span = f32(rng.uniform(16.0, 1900.0))
        edge = np.nextafter(y0, f32(-np.inf if i % 2 else np.inf))
        far = f32(edge - span) if i % 2 else f32(edge + span)
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


def em_on_rows(cy):
    """Segments on a sample row: a flat line on it (no crossing at all: the
    kernel drops it before the hull test), lines and curves ending on it, a
    curve whose vertex touches it, and zero padding."""
    y = cy[len(cy) // 2]
    d = f32(5 / CULL_SCALE)
    return np.array([
        [0, y, 500, y, 1000, y],
        [0, y, 50, y - d, 100, y - 2 * d],
        [0, y - 2 * d, 50, y - d, 100, y],
        [0, y - d, 50, y + d, 100, y - d],
        [0, y, 50, y + d, 100, y],
        [0, 0, 0, 0, 0, 0],
    ], f32)


def block_kept(q, cy):
    """The kernel's cull on one block's rows ``cy`` (float32, falling), bool
    ``[S, R]``: a segment with no crossing on any row (``a == 0`` and ``p2y
    == p0y``, segment_crossings' own test) keeps none; any other keeps the
    rows within ``page_ref.margin`` of its control hull's y-range, the margin
    taken at the block's largest ``|cy|``."""
    q = torch.as_tensor(q)
    cy = torch.as_tensor(cy)
    p0y, p1y, p2y = q[:, 1], q[:, 3], q[:, 5]
    a = p0y - 2 * p1y + p2y
    dead = (a == 0) & ~((p2y - p0y) != 0)
    ymax = max(abs(float(cy[0])), abs(float(cy[-1])))
    m = page_ref.margin(q, ymax)
    ys = q[:, 1::2].double()
    lo, hi = ys.amin(1) - m, ys.amax(1) + m
    y = cy.double()[None]
    return (y >= lo[:, None]) & (y <= hi[:, None]) & ~dead[:, None]


def dropped_crossings(q, cy, rows):
    """(segment, row) pairs with a crossing on the rows ``cy`` that the cull
    of blocks of ``rows`` rows drops."""
    q = torch.as_tensor(q)
    dropped = 0
    for r0 in range(0, len(cy), rows):
        block = torch.from_numpy(np.ascontiguousarray(cy[r0:r0 + rows]))
        roots, _ = page_ref.row_roots(q, block)
        dropped += int(((roots > 0) & ~block_kept(q, block)).sum())
    return dropped


@pytest.mark.parametrize("oy", CULL_OFFSETS)
class TestCull:
    """The row cull keeps every crossing of the plain version: on 16- and
    64-row blocks of a 64 px tile, and on K4's row bands (the 2 x 2 mesh's
    second 32-row band: anchors ``max_y - 32``, height 32), at the paths'
    sample offsets."""

    LAYOUTS = {"tile": (CULL_MAX_Y, CULL_SIZE), "band": (CULL_MAX_Y - 32, 32)}

    def cases(self, font, cy):
        yield "ulp slivers", em_slivers(cy)
        yield "near lines", em_near_lines()
        yield "on rows", em_on_rows(cy)

    @pytest.mark.parametrize("layout", ["tile", "band"])
    @pytest.mark.parametrize("rows", [16, 64])
    def test_keeps_every_crossing(self, font, oy, layout, rows, one_torch_thread):
        max_y, h = self.LAYOUTS[layout]
        cy = row_ys(max_y, h, oy)
        for name, q in self.cases(font, cy):
            assert dropped_crossings(q, cy, rows) == 0, name
        segs, min_x, gmax_y, scale = glyph_batch(font, "AQg@&%Wb", CULL_SIZE, CULL_SIZE)
        for i in range(len(segs)):
            gy = row_ys(gmax_y[i] - (CULL_MAX_Y - max_y), h, oy, scale)
            assert dropped_crossings(segs[i].reshape(-1, 6), gy, rows) == 0, f"glyph {i}"

    def test_cases_cross_outside_the_hull(self, oy, one_torch_thread):
        """The slivers and near lines are what the margin is for: without it
        they cross."""
        cy = row_ys(CULL_MAX_Y, CULL_SIZE, oy)
        for q in (em_slivers(cy), em_near_lines()):
            q = torch.from_numpy(q)
            roots, _ = page_ref.row_roots(q, torch.from_numpy(cy))
            ys = q[:, 1::2]
            outside = ((torch.from_numpy(cy)[None] > ys.amax(1)[:, None])
                       | (torch.from_numpy(cy)[None] < ys.amin(1)[:, None]))
            assert ((roots > 0) & outside).sum() > 0

    def test_margin_one_unit_short_drops_crossings(self, monkeypatch, oy, one_torch_thread):
        full = page_ref.margin
        monkeypatch.setattr(page_ref, "margin", lambda q, ymax: full(q, ymax) - 1.0)
        cy = row_ys(CULL_MAX_Y, CULL_SIZE, oy)
        assert dropped_crossings(em_slivers(cy), cy, 16) > 0

    def test_fixed_margin_drops_near_line_crossings(self, monkeypatch, oy, one_torch_thread):
        monkeypatch.setattr(page_ref, "margin",
                            lambda q, ymax: torch.ones(len(q), dtype=torch.float64))
        cy = row_ys(CULL_MAX_Y, CULL_SIZE, oy)
        assert dropped_crossings(em_near_lines(), cy, 64) > 0


def sliver_batch(oy):
    """The cull's cases as a winding batch on the 64 px tile, with the
    near-line glyph of ``test_torch_windows.py`` (a closed near-straight
    quadratic whose roots stray rows away)."""
    cy = row_ys(CULL_MAX_Y, CULL_SIZE, oy)
    line = np.array([[100, 1200, 1000, 1200 + 2.0**-13, 1900, 1200],
                     [1900, 1200, 1000, 1200, 100, 1200]], f32)
    qs = [em_slivers(cy), em_near_lines(), em_on_rows(cy), line]
    n = max(len(q) for q in qs)
    segs = np.zeros((len(qs), n, 3, 2), f32)
    for i, q in enumerate(qs):
        segs[i, : len(q)] = q.reshape(-1, 3, 2)
    return segs, np.zeros(len(qs), np.int32), np.full(len(qs), CULL_MAX_Y, np.int32), CULL_SCALE


# -- the launch plan: winding.cu's make_plan, transcribed --------------------

SMEM_LIMIT, SMEM_TARGET = 227 * 1024, 45 * 1024
THREADS, WARPS, SMALL_CHUNK, MAX_ROWS, MAX_PLAN_ROWS = 256, 8, 32, 64, 256
FILL_BLOCKS_PER_SM, MIN_ROWS = 2, 8
H100_SMS = 132  # the SMs of an H100 SXM, which the labelled cases assume


def block_smem(chunk, w, wp, rows):
    return rows * wp * 4 + w * 4 + rows * 4 + chunk * 6 * 4 + WARPS * 4 + chunk * rows * 2


def fit_rows(band, w):
    """The rows a block that fit the shared-memory target, up to MAX_ROWS."""
    wp = (w + 3) // 4 * 4
    rows = 1
    while rows < min(MAX_ROWS, band) and block_smem(THREADS, w, wp, rows + 1) <= SMEM_TARGET:
        rows += 1
    return rows


def spread_evenly(band, rows):
    return -(-band // -(-band // rows))


def launch_plan(b, h, w, win_rows=0, sms=H100_SMS):
    """(rows, chunk, cells a lane, shared bytes) of the launch that
    ``winding()`` (``win_rows`` 0) or ``winding_windows()`` makes for ``b``
    glyphs on a card of ``sms`` SMs, None where no block fits. The card
    holds it to the C (``TestPlanOnCard.test_plan_matches_transcription``)."""
    band = win_rows if 0 < win_rows < h else h
    units = b * -(-h // win_rows) if win_rows else b
    wp = (w + 3) // 4 * 4
    if block_smem(THREADS, w, wp, 1) <= SMEM_LIMIT:
        rows = fit_rows(band, w)
        fill = FILL_BLOCKS_PER_SM * sms
        if units * -(-band // rows) < fill:
            per_unit = -(-fill // units)
            rows = min(rows, max(-(-band // per_unit), min(MIN_ROWS, band)))
        rows = spread_evenly(band, rows)
        return rows, THREADS, 4 if w >= 128 else 2, block_smem(THREADS, w, wp, rows)
    smem = block_smem(SMALL_CHUNK, w, w, 1)
    return (1, SMALL_CHUNK, 1, smem) if smem <= SMEM_LIMIT else None


def plan_path(plan, h, w, win_rows=0):
    """The path a plan takes: the least block; or a band of the whole
    height (or window), several bands, or bands cut shorter than the shared
    memory allows because the batch is small; with 4 or 2 cells a lane."""
    if plan[1] == SMALL_CHUNK:
        return "least"  # one row, a chunk of 32, rows of exactly W cells
    band = win_rows if 0 < win_rows < h else h
    if plan[0] < spread_evenly(band, fit_rows(band, w)):
        kind = "spread"
    else:
        kind = "whole" if plan[0] == band else "bands"
    return f"{kind}/{plan[2]}"


def first_port_served(h, w, win_rows=0):
    """Whether the first port's winding() (``win_rows`` 0) or
    winding_windows() launched at this shape: its chunk of 64 segments, cy,
    cx and ``W + 1`` buckets a row fit a block's shared memory, and
    winding()'s 16-row bands fit the grid's 65,535."""
    fixed = 64 * 6 * 4 + w * 4
    per_row = 4 + (w + 1) * 4
    if win_rows:
        return fixed + min(win_rows, h) * per_row <= SMEM_LIMIT
    if fixed + per_row > SMEM_LIMIT:
        return False
    rows = min((SMEM_LIMIT - fixed) // per_row, 16, h)
    return -(-h // rows) <= 65535


# (glyphs, height, width, win_rows, path): the labelled cases of both entries
PLAN_CASES = [
    (1024, 64, 64, 0, "bands/2"),      # cjk64: two 32-row bands a glyph
    (1024, 32, 32, 0, "whole/2"),      # cjk32: a glyph a block
    (94, 256, 256, 0, "bands/4"),      # ascii256: 24-row bands
    (256, 64, 64, 0, "bands/2"),       # a K4 shard of cjk64
    (512, 32, 64, 0, "whole/2"),       # a K4 band of cjk64 on 2 x 2
    (8, 128, 640, 0, "spread/4"),      # entry()'s batch: 8-row bands
    (1, 188, 172, 0, "spread/4"),      # the quick start's 'A'
    (16, 8, 128, 0, "whole/4"),        # the dry runs' 8-row tiles
    (3, 37, 129, 0, "spread/4"),       # widths that are a multiple of nothing
    (1000, 5, 61, 0, "whole/2"),
    (1, 2, 28500, 0, "least"),         # not one row beside a full chunk
    (1024, 64, 64, 32, "whole/2"),     # the windowed cjk64 / synth64: a window a block
    (1024, 32, 32, 16, "whole/2"),     # cjk32 / synth32
    (1000, 128, 128, 128, "bands/4"),  # 128-row windows in bands
    (1000, 48, 48, 32, "whole/2"),     # a last window cut by the height
    (2, 64, 64, 32, "spread/2"),       # a small windowed batch
    (1, 2, 28500, 16, "least"),
]

# (glyphs, height, width, rows, cells a lane): plans that winding() takes at
# these shapes, a band of the whole height, evenly spread bands, single rows
# and the least block, at widths that are and are not multiples of the
# vector stores'
EVERY_PLAN = [
    (300, 64, 24, 64, 2),
    (300, 64, 23, 64, 2),
    (300, 16, 60, 16, 2),
    (300, 16, 61, 16, 2),
    (300, 16, 256, 16, 4),
    (24, 64, 1500, 5, 4),
    (24, 64, 1501, 5, 4),
    (300, 5, 60, 5, 2),
    (300, 1, 64, 1, 2),
    (300, 1, 201, 1, 4),
    (8, 64, 64, 8, 2),
    (1, 2, 28500, 1, 1),
]

# (glyphs, width, rows) of the 64-row sliver batch: 8-row spread bands, one
# band of 16 rows in four, and the whole tile in one block
SLIVER_PLANS = [(4, 64, 8), (68, 400, 16), (264, 24, 64)]


class TestLaunchPlan:
    @pytest.mark.parametrize("b,h,w,win_rows,path", PLAN_CASES)
    def test_cases_take_their_path(self, b, h, w, win_rows, path):
        assert plan_path(launch_plan(b, h, w, win_rows), h, w, win_rows) == path

    def test_small_batches_spread_down_to_eight_rows(self):
        assert launch_plan(1, 188, 172)[0] == 8 and launch_plan(8, 128, 640)[0] == 8
        assert launch_plan(1, 5, 64)[0] == 5  # a band shorter than eight rows
        assert launch_plan(20, 256, 256)[0] == 19  # 14 bands a glyph: 280 blocks
        assert launch_plan(94, 256, 256)[0] == 24

    def test_least_block_just_above_a_full_chunk(self):
        """The widest row beside a full chunk, and the next width: the least
        block's."""
        widest = max(w for w in range(28000, 29000)
                     if block_smem(THREADS, w, (w + 3) // 4 * 4, 1) <= SMEM_LIMIT)
        assert launch_plan(1, 1, widest)[1] == THREADS
        assert launch_plan(1, 1, widest + 1)[1] == SMALL_CHUNK

    @pytest.mark.parametrize("win_rows", [0, 16, 32, 128, 200])
    def test_serves_every_shape_the_first_port_served(self, win_rows):
        for b in (1, 1024):
            for h in (1, 2, 16, 17, 64, 128, 640, 2**20 + 3):
                for w in [*range(1, 30001, 97), 28863, 28864, 28947, 28948]:
                    if first_port_served(h, w, win_rows):
                        assert launch_plan(b, h, w, win_rows) is not None, (b, h, w)

    def test_beyond_the_first_ports_grid(self):
        """A band of 2^20 rows needed more than 65,535 of the first port's
        16-row blocks: the grid-stride loop serves it."""
        assert not first_port_served(2**20 + 3, 8)
        assert launch_plan(1, 2**20 + 3, 8) is not None

    def test_rows_spread_evenly_within_the_pair_list(self):
        """At most 256 rows a block (a pair names its row in 8 bits), at most
        the band, and bands that differ by less than one row a band."""
        for b in (1, 8, 1024):
            for h in (1, 5, 16, 31, 64, 100, 256, 1000):
                for w in (1, 8, 64, 127, 128, 256, 640, 4000, 28000):
                    for win_rows in (0, 16, 32, 128):
                        rows, _, _, smem = launch_plan(b, h, w, win_rows)
                        band = win_rows if 0 < win_rows < h else h
                        bands = -(-band // rows)
                        assert 1 <= rows <= min(MAX_PLAN_ROWS, band) and smem <= SMEM_LIMIT
                        assert band - (bands - 1) * rows > rows - bands

    def test_overflow_has_no_plan(self):
        assert launch_plan(1, 2, 29000) is None

    @pytest.mark.parametrize("b,h,w,rows,cols", EVERY_PLAN)
    def test_every_plan_case_takes_its_plan(self, b, h, w, rows, cols):
        plan = launch_plan(b, h, w)
        assert (plan[0], plan[2]) == (rows, cols)

    @pytest.mark.parametrize("b,w,rows", SLIVER_PLANS)
    def test_sliver_cases_take_their_rows(self, b, w, rows):
        assert launch_plan(b, CULL_SIZE, w)[0] == rows

    def test_fill_scales_with_the_sms(self):
        """A small batch is cut into bands for two blocks an SM: a card with
        fewer SMs cuts it less."""
        assert launch_plan(20, 256, 256, sms=132)[0] == 19
        assert launch_plan(20, 256, 256, sms=66)[0] == 24  # 11 bands a glyph: 220 blocks
        assert launch_plan(1, 188, 172, sms=1)[0] == 32  # six 32-row bands fill one SM


def tiled(arrays, b):
    """Each of ``arrays`` repeated along dim 0 to ``b`` entries."""
    return [np.resize(a, (b, *a.shape[1:])) for a in arrays]


@pytest.mark.requires_cuda
class TestPlanOnCard:
    @pytest.mark.parametrize("b,h,w,path", [(b, h, w, p) for b, h, w, r, p in PLAN_CASES
                                            if not r])
    def test_paths(self, cuda, font, b, h, w, path):
        """Each labelled path's plan from the library, and its kernel equal to
        the plain version, at a few sample offsets."""
        assert plan_path(winding.plan(b, h, w), h, w) == path
        segs, min_x, max_y, scale = glyph_batch(font, "AQg@&%Wb", 64, 64)
        segs, min_x, max_y = tiled((segs, min_x, max_y), b)
        max_y = max_y - 30 + h // 2  # rows through the middle of the glyphs
        min_x = min_x - w // 2 + 32
        args = (torch.from_numpy(segs).to(cuda), torch.from_numpy(min_x).to(cuda),
                torch.from_numpy(max_y).to(cuda), float(scale))
        for offset in [(0.0, 0.0), (0.25, -1 / 3), (-0.5, 1.0)]:
            before = winding.launches
            out = winding.winding_batch(*args, height=h, width=w, sample_offset=offset)
            torch.cuda.synchronize()
            assert winding.launches == before + 1
            want = winding_ref.winding_batch(*args, height=h, width=w, sample_offset=offset)
            assert torch.equal(out, want) and bool((out != 0).any())

    @pytest.mark.parametrize("b,h,w,rows,cols", EVERY_PLAN)
    def test_every_plan(self, cuda, font, b, h, w, rows, cols):
        """Each plan ``winding()`` takes, on glyphs and 300-segment strokes,
        rows through their middle: the plan does not change the function."""
        plan = winding.plan(b, h, w)
        assert (plan[0], plan[2]) == (rows, cols)
        for segs, min_x, max_y, scale in (glyph_batch(font, "AQg@&%Wb", 64, 64),
                                          synthetic_batch(64)):
            segs, min_x, max_y = tiled((segs, min_x, max_y), b)
            args = (torch.from_numpy(segs).to(cuda),
                    torch.from_numpy(min_x - w // 2 + 32).to(cuda),
                    torch.from_numpy(max_y - 30 + h // 2).to(cuda), float(scale))
            for offset in [(0.0, 0.0), (0.25, -0.25), (1 / 3, 1.0)]:
                out = winding.winding_batch(*args, height=h, width=w, sample_offset=offset)
                want = winding_ref.winding_batch(*args, height=h, width=w,
                                                 sample_offset=offset)
                assert torch.equal(out, want) and bool((out != 0).any())

    @pytest.mark.parametrize("oy", [0.0, 0.25, -1 / 3, 1.0])
    def test_slivers_and_near_lines(self, cuda, oy):
        """The row cull's hard cases: crossings one ulp outside a hull and the
        strays of nearly straight curves, in blocks of 8, 16 and 64 rows."""
        batch = sliver_batch(oy)
        for b, w, rows in SLIVER_PLANS:
            segs, min_x, max_y = tiled(batch[:3], b)
            assert winding.plan(b, CULL_SIZE, w)[0] == rows
            args = (torch.from_numpy(segs).to(cuda), torch.from_numpy(min_x).to(cuda),
                    torch.from_numpy(max_y).to(cuda), float(batch[3]))
            kw = dict(height=CULL_SIZE, width=w, sample_offset=(0.0, oy))
            out = winding.winding_batch(*args, **kw)
            want = winding_ref.winding_batch(*args, **kw)
            assert torch.equal(out, want) and bool((out != 0).any())

    def test_tall_band_beyond_the_old_grid_limit(self, cuda):
        """2^20 rows of one glyph: the first port's grid had no room for its
        65,536 16-row bands."""
        segs, min_x, max_y, scale = synthetic_batch(64)
        h = 2**20 + 3
        args = (torch.from_numpy(segs[:1]).to(cuda), torch.from_numpy(min_x[:1]).to(cuda),
                torch.full((1,), h // 2, dtype=torch.int32, device=cuda), 1.0 / 64)
        out = winding.winding_batch(*args, height=h, width=8)
        want = winding_ref.winding_batch(*args, height=h, width=8)
        assert torch.equal(out, want) and bool((out != 0).any())

    def test_plan_matches_transcription(self, cuda):
        card = torch.cuda.get_device_properties(cuda).multi_processor_count
        assert winding.plan(8, 64, 64) == winding.plan(8, 64, 64, sms=card)
        for sms in (card, 1, 66, H100_SMS):
            for b in (1, 8, 20, 94, 1024):
                for h in (1, 2, 7, 8, 16, 32, 33, 64, 100, 128, 256, 640, 2**20 + 3):
                    for w in (1, 3, 32, 37, 64, 127, 128, 129, 256, 640, 1003, 4000, 16384,
                              28200, 28300, 28947, 28948, 30000):
                        for win_rows in (0, 16, 32, 128):
                            assert (winding.plan(b, h, w, win_rows, sms=sms)
                                    == launch_plan(b, h, w, win_rows, sms=sms)), \
                                (b, h, w, win_rows, sms)

    def test_no_plan_raises(self, cuda):
        segs = torch.zeros((1, 4, 3, 2), device=cuda)
        anchors = torch.zeros(1, dtype=torch.int32, device=cuda)
        before = winding.launches
        with pytest.raises(RuntimeError, match="winding kernel launch failed"):
            winding.winding_batch(segs, anchors, anchors, 1.0, height=2, width=29000)
        assert winding.launches == before

