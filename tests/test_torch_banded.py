"""fontrx_torch's row-banded strips (K5 and K6's function) against the JAX
package's, on the CPU, and the CUDA kernel against the plain version on the
card.

- ``winding_ref.winding_banded_batch`` equals K5
  (``winding_pallas_banded_batch``, width 128) and K6
  (``winding_dense_banded_batch``, width = the band's rows) in interpret mode
  with ``exact=True``, bit for bit: R = 2 at 64 px and R = 4 at 32 px, at
  offset 0 and at a nonzero sample offset, on strips of x-sorted DejaVu
  glyphs with each element's slots shuffled (owners in scrambled order), the
  same glyph in two bands at other anchors, an empty band, owners outside
  ``[0, R)``, and the near-line of ``tests/test_torch_windows.py`` in each
  band position beside synthetic glyphs, whose float program strays off its
  hull's rows. (K3 differs from the port on the near-line where XLA:CPU
  fuses multiply-adds, ``test_torch_windows.py``; K5 and K6 equal it here
  with and without ``--xla_cpu_max_isa=AVX``, so they run in this process.)
- Each band of the plain strips equals ``winding_ref.winding_batch`` per glyph
  at the band's anchors over the band's own segments.
- ``bench.banded.build_banded`` equals the probe's own,
  ``tools/tpu_probes/tpu_banded.py::build_banded``, array for array, and its
  x-sort is ``tpu_dense_banded.py``'s per-glyph x-sort.
- The wrapper sends CPU tensors to the plain version and refuses a band
  count that does not divide 128 and inputs of the wrong type or shape.

The module imports JAX only inside the tests that compare with it, so the
card's tests also run where there is none:
``python -m pytest --noconftest -m requires_cuda tests/test_torch_banded.py``.
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from fontrx_torch.bench import banded, cjk
from fontrx_torch.font.font import Font
from fontrx_torch.kernels import winding, winding_ref
from fontrx_torch.kernels.grid import RasterGrid
from fontrx_torch.pack.segments import glyph_segments, xsort_segments
from tests import test_torch_winding as wt

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHARS = "Ag@Q&%8B"
# (bands, px): a band of px rows, R of them a 128-row strip
SETUPS = [(2, 64), (4, 32)]
OFFSETS = [(0.0, 0.0), (0.375, -0.625)]
CASES = [(r, px, off) for r, px in SETUPS for off in OFFSETS]
IDS = [f"R{r}-{px}px-off{i}" for r, px in SETUPS for i in range(len(OFFSETS))]

f32 = np.float32
T = torch.from_numpy


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch on one thread: with one per core, parallel test workers spin
    against each other (``tests/test_torch_sharding.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def near_line(y=1200.0, d=2.0**-13):
    """The near-line glyph of ``tests/test_torch_windows.py``: a nearly
    straight quadratic from (100, y) to (1900, y), its control point ``d``
    font units above, and the flat line back. At 64 px its float program
    finds a double root on rows 23-39, off its hull's rows 25-26."""
    return np.array([[[100, y], [1000, y + d], [1900, y]],
                     [[1900, y], [1000, y], [100, y]]], f32)


def strip_inputs(bands, px, seed=5):
    """Strips of ``bands`` bands of ``px`` rows at ``px / 2048`` px a font
    unit: ``(segments, owners, min_x, max_y, scale)`` as NumPy arrays, and
    per element and band the glyph's segments (``[]`` for none).

    - element 0: ``bands`` DejaVu glyphs, x-sorted;
    - element 1: one glyph in bands 0 and 1 at other anchors, band 2 (R = 4)
      empty, band 3 a glyph;
    - element 2: a glyph in band 0, band 1 empty, and glyphs owned by ``R``,
      ``R + 3`` and ``-1``, which add nothing;
    - element ``3 + k``: the near-line in band ``k``, synthetic glyphs in
      the others, all at ``min_x = 0``, ``max_y = px - 1``.

    Every element's slots are shuffled, owners with their segments, and
    padded with zero segments of random owners.
    """
    rng = np.random.default_rng(seed)
    font = Font.open(banded.DEJAVU)
    upem = font.info.units_per_em
    glyphs = {c: font.get_glyph(c)[0] for c in CHARS}

    def dejavu(c, dx=0, dy=0):
        g = glyphs[c]
        grid = RasterGrid.fixed_tile((g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max),
                                     px, upem, px)
        return xsort_segments(glyph_segments(g)), grid.min_x + dx, grid.max_y + dy

    def synthetic():
        return cjk.synthetic_strokes(rng, 48), 0, px - 1

    elements = [
        {k: dejavu(CHARS[k]) for k in range(bands)},
        {0: dejavu("B"), 1: dejavu("B", -7, 5), **({3: dejavu("g")} if bands == 4 else {})},
        {0: dejavu("Q"), bands: dejavu("@"), bands + 3: dejavu("%"), -1: dejavu("8")},
    ]
    for k in range(bands):
        elements.append({j: (near_line(), 0, px - 1) if j == k else synthetic()
                         for j in range(bands)})

    b = len(elements)
    cap = max(sum(len(s) for s, _, _ in e.values()) for e in elements) + 5
    segments = np.zeros((b, cap, 3, 2), f32)
    owners = rng.integers(0, bands, (b, cap)).astype(np.int32)
    min_x = np.zeros((bands, b), np.int32)
    max_y = np.zeros((bands, b), np.int32)
    per_band = [[[] for _ in range(bands)] for _ in range(b)]
    for e, element in enumerate(elements):
        slots = rng.permutation(cap)
        start = 0
        for owner, (seg, mx, my) in element.items():
            idx = slots[start : start + len(seg)]
            start += len(seg)
            segments[e, idx] = seg
            owners[e, idx] = owner
            if 0 <= owner < bands:
                min_x[owner, e], max_y[owner, e] = mx, my
                per_band[e][owner] = seg
    return (segments, owners, min_x, max_y, f32(px / cjk.UPEM)), per_band


def plain(inputs, width, offset=(0.0, 0.0)):
    segments, owners, min_x, max_y, scale = inputs
    return winding_ref.winding_banded_batch(
        T(segments), T(owners), T(min_x), T(max_y), float(scale), width=width,
        sample_offset=offset).numpy()


def jax_banded(kernel, inputs, bands, width, offset):
    """K5 (``kernel="k5"``, width a multiple of 128) or K6 (``"k6"``, width
    at most 128) in interpret mode, exact."""
    import jax.numpy as jnp

    from fontrx.kernels.winding_dense import winding_dense_banded_batch
    from fontrx.kernels.winding_pallas_v2 import winding_pallas_banded_batch

    fn = winding_pallas_banded_batch if kernel == "k5" else winding_dense_banded_batch
    segments, owners, min_x, max_y, scale = (jnp.asarray(a) for a in inputs)
    return np.asarray(fn(segments, owners, min_x, max_y, scale, width=width, row_bands=bands,
                         interpret=True, exact=True, sample_offset=offset))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


class TestAgainstJax:
    """The plain strips against K5 and K6 in interpret mode, bit for bit."""

    @pytest.mark.parametrize("bands,px,offset", CASES, ids=IDS)
    def test_k5(self, bands, px, offset):
        inputs, _ = strip_inputs(bands, px)
        np.testing.assert_array_equal(plain(inputs, 128, offset),
                                      jax_banded("k5", inputs, bands, 128, offset))

    @pytest.mark.parametrize("bands,px,offset", CASES, ids=IDS)
    def test_k6(self, bands, px, offset):
        inputs, _ = strip_inputs(bands, px)
        np.testing.assert_array_equal(plain(inputs, px, offset),
                                      jax_banded("k6", inputs, bands, px, offset))


class TestPlain:
    @pytest.mark.parametrize("bands,px,offset", CASES, ids=IDS)
    def test_bands_are_per_glyph_winding(self, bands, px, offset):
        """Band ``k`` of each element is ``winding_batch`` of the band's own
        glyph at its anchors (zeros for an empty band), at a width that is
        neither K5's nor K6's."""
        inputs, per_band = strip_inputs(bands, px)
        _, _, min_x, max_y, scale = inputs
        width = px + 3
        strips = plain(inputs, width, offset)
        assert strips.shape == (len(per_band), 128, width) and strips.dtype == np.int32
        for e, element in enumerate(per_band):
            for k, seg in enumerate(element):
                rows = strips[e, k * px : (k + 1) * px]
                if not len(seg):
                    assert not rows.any()
                    continue
                want = winding_ref.winding_batch(
                    T(np.asarray(seg, f32)[None]), T(min_x[k, e : e + 1]),
                    T(max_y[k, e : e + 1]), float(scale), height=px, width=width,
                    sample_offset=offset).numpy()[0]
                np.testing.assert_array_equal(rows, want)

    @pytest.mark.parametrize("bands,px", SETUPS)
    def test_near_line_strays_in_every_band(self, bands, px):
        """The near-line's rounded roots ink rows off its hull's rows in each
        band position, and the strip keeps them."""
        inputs, _ = strip_inputs(bands, px)
        strips = plain(inputs, px)
        hull_row = (px - 1) - 1200 * px / cjk.UPEM  # the line's row
        for k in range(bands):
            rows = np.nonzero(strips[3 + k, k * px : (k + 1) * px].any(axis=1))[0]
            assert len(rows) and (abs(rows - hull_row) > 2).any(), rows

    def test_widths_agree_and_width_zero(self):
        inputs, _ = strip_inputs(2, 64)
        np.testing.assert_array_equal(plain(inputs, 128)[:, :, :64], plain(inputs, 64))
        assert plain(inputs, 0).shape == (len(inputs[0]), 128, 0)


def jax_probe():
    """``tools/tpu_probes/tpu_banded.py``, loaded by path (its ``main`` is
    guarded)."""
    spec = importlib.util.spec_from_file_location(
        "tpu_banded", ROOT / "tools" / "tpu_probes" / "tpu_banded.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# 23 bucket glyphs: the last element of 2 and of 4 bands is partial
N_BUILD = 23


@pytest.fixture(scope="module")
def build_glyphs():
    """The first ``N_BUILD`` bucket glyphs of DejaVu Sans in both packages,
    and the port's 64 px tiles."""
    from fontrx.font.font import Font as JaxFont

    font = Font.open(banded.DEJAVU)
    ours = banded.bucket(font, N_BUILD)
    jax_font = JaxFont.open(str(banded.DEJAVU))
    theirs = []
    for i in range(font.num_glyphs):
        if len(theirs) == N_BUILD:
            break
        if 0 < font.load_glyph_safe(i).num_segments <= banded.BUCKET:
            theirs.append(jax_font.load_glyph_safe(i))
    grids = [RasterGrid.fixed_tile((g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max),
                                   64, font.info.units_per_em, 64) for g in ours]
    return ours, theirs, grids


class TestBuild:
    @pytest.mark.parametrize("bands", [2, 4])
    def test_matches_the_probe(self, build_glyphs, bands):
        ours, theirs, grids = build_glyphs
        want = jax_probe().build_banded(theirs, grids, bands)
        got = banded.build_banded(ours, grids, bands)
        assert got[4] == want[4]
        for a, b in zip(got[:4], want[:4]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("bands", [2, 4])
    def test_x_sort_is_per_glyph(self, build_glyphs, bands):
        """``sort="x"`` x-sorts each glyph's run in place, as
        ``tpu_dense_banded.py:91-113`` does with the JAX package's
        ``xsort_segments``."""
        from fontrx.pack.segments import xsort_segments as jax_xsort

        ours, _, grids = build_glyphs
        segs, owners, min_x, max_y, cap = banded.build_banded(ours, grids, bands)
        want = segs.copy()
        for e in range(len(segs)):
            start = 0
            for k in range(bands):
                n = len(glyph_segments(ours[e * bands + k])) if e * bands + k < N_BUILD else 0
                want[e, start : start + n] = jax_xsort(segs[e, start : start + n])
                start += n
        got = banded.build_banded(ours, grids, bands, sort="x")
        np.testing.assert_array_equal(got[0], want)
        for a, b in zip(got[1:], (owners, min_x, max_y, cap)):
            np.testing.assert_array_equal(a, b)

    def test_bucket_is_the_full_font(self):
        glyphs = banded.bucket(Font.open(banded.DEJAVU))
        assert len(glyphs) == 6022
        assert sum(g.num_segments for g in glyphs) == 132302


class TestWrapper:
    def test_cpu_tensors_run_the_plain_version(self):
        inputs, _ = strip_inputs(4, 32)
        segments, owners, min_x, max_y, scale = inputs
        before = winding.banded_launches
        got = winding.winding_banded_batch(T(segments), T(owners), T(min_x), T(max_y),
                                           float(scale), width=40, sample_offset=(0.5, 0.25))
        assert winding.banded_launches == before
        np.testing.assert_array_equal(got.numpy(), plain(inputs, 40, (0.5, 0.25)))

    @pytest.mark.parametrize("change,error", [
        (dict(bands=3), ValueError),
        (dict(bands=0), ValueError),
        (dict(bands=256), ValueError),
        (dict(owners=np.int64), TypeError),
        (dict(owners_shape=(2, 9)), ValueError),
        (dict(segments=np.float64), TypeError),
        (dict(segments_shape=(2, 8, 2, 2)), ValueError),
        (dict(min_x=np.int64), TypeError),
        (dict(min_x_shape=(2, 3)), ValueError),
        (dict(max_y_shape=(4, 2)), ValueError),
        (dict(width=-1), ValueError),
    ], ids=lambda v: json.dumps(v, default=str) if isinstance(v, dict) else v.__name__)
    def test_refuses(self, change, error):
        """A band count that does not divide 128, and inputs of the wrong
        type or shape, on any device."""
        bands = change.get("bands", 2)
        segments = np.zeros(change.get("segments_shape", (2, 8, 3, 2)),
                            change.get("segments", np.float32))
        owners = np.zeros(change.get("owners_shape", (2, 8)), change.get("owners", np.int32))
        min_x = np.zeros(change.get("min_x_shape", (bands, 2)), change.get("min_x", np.int32))
        max_y = np.zeros(change.get("max_y_shape", (bands, 2)), np.int32)
        with pytest.raises(error):
            winding.winding_banded_batch(T(segments), T(owners), T(min_x), T(max_y), 0.03125,
                                         width=change.get("width", 64))


class TestProbe:
    def test_cpu_run(self):
        """The probe's cases on 8 glyphs on the CPU: a record a case (a JSON
        line of ``main``), the strips equal to the per-glyph maps, no time."""
        lines = [json.loads(json.dumps(banded.run_case(c, "cpu"))) for c in banded.cases(8)]
        assert [r["case"] for r in lines] == ["dejavu64", "dejavu32", "synth64", "synth32"]
        for r in lines:
            assert r["glyphs"] == 8 and r["elements"] == 8 // r["bands"] and r["differ"] == 0
            assert r["ink"] > 0 and r["ms"] is None and r["card"] is None
            assert r["launches"] == r["winding_launches"] == 0

    def test_bound_counts_the_per_glyph_pairs(self):
        """The strips solve the pairs the per-glyph winding solves: the same
        crossings, and operations that differ only by the pixels of the
        strips' empty band slots."""
        from fontrx_torch import bound

        for case in banded.cases(8)[:2] + [banded.cases(12)[1]]:
            segments, owners, _, max_y = case.strip
            ops, crossings = bound.banded_work(segments, owners, max_y, case.scale,
                                               width=case.size)
            g_ops, _, g_crossings = bound.winding_work(
                case.glyph[0], case.glyph[1], case.glyph[3], case.scale, height=case.size,
                width=case.size)
            slots = len(segments) * max_y.shape[0] - case.glyphs
            assert crossings == g_crossings > 0
            assert ops - g_ops == slots * case.size * case.size

    @pytest.mark.parametrize("padded", [False, True], ids=["live", "padded"])
    def test_bytes_skip_foreign_segments(self, padded):
        """Owners outside the bands and all-zero padding segments are not
        charged: ``banded_bytes`` counts the segments ``banded_work`` solves."""
        from fontrx_torch import bound

        owners = np.array([[0, 1, 2, -1], [1, 1, 0, 7]], np.int32)
        segments = np.ones((2, 4, 3, 2), np.float32)
        owned = 5
        if padded:
            # a third element, all padding of band 0, and a padding slot of
            # band 1 in the first
            owners = np.concatenate([owners, np.zeros((1, 4), np.int32)])
            segments = np.concatenate([segments, np.zeros((1, 4, 3, 2), np.float32)])
            segments[0, 1] = 0
            owned = 4
        b = len(owners)
        # the owned live segments, every owner, 2 bands of anchors an element,
        # the strips
        assert (bound.banded_bytes(segments, owners, 2, 10)
                == owned * 24 + b * 4 * 4 + 2 * b * 8 + b * 128 * 10 * 4)


# -- the launch plan: winding.cu's banded_plan, transcribed -----------------

def list_cap(smem, s):
    """``banded_list_cap``: the room the plan leaves below the shared-memory
    target, at least one pass of the owners, at most ``s`` rounded up to
    whole warps, within the limit; 0 when not one fits."""
    cap = max((wt.SMEM_TARGET - smem) // 4, wt.THREADS)
    whole = -(-s // 32) * 32
    if cap > whole:
        cap = max(whole, 32)
    return max(min(cap, (wt.SMEM_LIMIT - smem) // 4), 0)


def banded_launch_plan(b, s, bands, w, sms=wt.H100_SMS):
    """(rows, chunk, cells a lane, shared bytes with the list, the list's
    capacity) of the launch ``winding_banded()`` makes for ``b`` elements of
    ``s`` segment slots in ``bands`` bands of ``w`` columns: ``winding()``'s
    plan for ``b * bands`` glyphs of ``128 / bands`` rows, and the list of a
    band's segments. None where no block fits. The card holds it to the C
    (``TestOnCard.test_plan_matches_transcription``)."""
    plan = wt.launch_plan(b * bands, winding_ref.STRIP_ROWS // bands, w, sms=sms)
    if plan is None:
        return None
    cap = list_cap(plan[3], s)
    return (*plan[:3], plan[3] + 4 * cap, cap) if cap else None


def first_port_served(w):
    """Whether the first port's ``winding_banded()`` launched at width
    ``w``: its ballot counts, a chunk of 64 segments, cx and one row of cy
    and ``W + 1`` buckets fit a block's shared memory (its grid, ``B`` x
    128 rows at most, always fit)."""
    return 16 + 64 * 6 * 4 + w * 4 + 4 + (w + 1) * 4 <= wt.SMEM_LIMIT


# (elements, slots, bands, width, rows, windows of the owners): the probe's
# four cases, one band a block, and owners taken in more than one window
BANDED_PLANS = [
    (3011, 128, 2, 64, 32, 1),      # dejavu64: 6,022 glyphs, cap 128 (8-rounded)
    (1506, 192, 4, 32, 32, 1),      # dejavu32
    (500, 576, 2, 64, 32, 1),       # synth64: 2 x 288 slots
    (250, 1152, 4, 32, 32, 1),      # synth32
    (3, 192, 128, 300, 1, 1),       # a band of one row (test_any_band_count)
    (2, 600, 128, 5000, 1, 3),      # the plan's rows fill the target: 256-owner windows
    (300, 4000, 1, 64, 43, 3),      # 1,613-owner windows beside 43 rows
    (2, 40, 2, 28900, 1, 1),        # the least block
]


class TestLaunchPlan:
    @pytest.mark.parametrize("b,s,bands,w,rows,windows", BANDED_PLANS)
    def test_cases_take_their_plan(self, b, s, bands, w, rows, windows):
        plan = banded_launch_plan(b, s, bands, w)
        assert plan[0] == rows and -(-s // plan[4]) == windows
        assert plan[3] <= wt.SMEM_LIMIT

    def test_probe_cases_keep_the_plan_of_winding(self):
        """The strips' blocks are those of the per-glyph ``winding()`` on the
        same glyphs, with the list beside them below the target."""
        for b, s, bands, w, _, _ in BANDED_PLANS[:4]:
            plan = banded_launch_plan(b, s, bands, w)
            assert plan[:3] == wt.launch_plan(b * bands, 128 // bands, w)[:3]
            assert plan[3] <= wt.SMEM_TARGET

    @pytest.mark.parametrize("bands", [1, 2, 4, 8, 32, 128])
    def test_serves_every_shape_the_first_port_served(self, bands):
        for b in (1, 1024):
            for s in (0, 1, 64, 2000):
                for w in [*range(1, 30001, 97), 28860, 28861, 28862, 28947, 28948]:
                    if first_port_served(w):
                        plan = banded_launch_plan(b, s, bands, w)
                        assert plan is not None and plan[4] >= 1, (b, s, bands, w)

    def test_the_first_ports_widest_row(self):
        widest = max(w for w in range(28000, 29000) if first_port_served(w))
        assert banded_launch_plan(1, 64, 1, widest)[1] == wt.SMALL_CHUNK
        assert banded_launch_plan(1, 64, 1, 28948) is None


@pytest.mark.requires_cuda
class TestOnCard:
    @pytest.mark.parametrize("bands,px,offset", CASES, ids=IDS)
    def test_kernel_equals_plain(self, cuda, bands, px, offset):
        inputs, _ = strip_inputs(bands, px)
        args = [T(a).to(cuda) for a in inputs[:4]]
        before = winding.banded_launches
        for width in (px, 128, px + 3):
            got = winding.winding_banded_batch(*args, float(inputs[4]), width=width,
                                               sample_offset=offset)
            want = winding_ref.winding_banded_batch(*args, float(inputs[4]), width=width,
                                                    sample_offset=offset)
            assert got.is_cuda and torch.equal(got, want)
        assert winding.banded_launches == before + 3

    @pytest.mark.parametrize("bands", [1, 8, 32, 128])
    def test_any_band_count(self, cuda, bands):
        rng = np.random.default_rng(bands)
        segs = cjk.make_batch(6, 96, seed=bands).reshape(3, 192, 3, 2)
        owners = rng.integers(-1, bands + 1, (3, 192)).astype(np.int32)
        min_x = rng.integers(-4, 4, (bands, 3)).astype(np.int32)
        max_y = rng.integers(30, 130, (bands, 3)).astype(np.int32)
        args = [T(a).to(cuda) for a in (segs, owners, min_x, max_y)]
        got = winding.winding_banded_batch(*args, 0.05, width=300)
        assert torch.equal(got, winding_ref.winding_banded_batch(*args, 0.05, width=300))

    def test_probe_cases(self, cuda):
        for case in banded.cases(64):
            rec = banded.run_case(case, cuda)
            assert rec["differ"] == 0 and rec["launches"] == rec["winding_launches"] == 1
            assert rec["ms"] > 0 and rec["card"]

    def test_plan_matches_transcription(self, cuda):
        card = torch.cuda.get_device_properties(cuda).multi_processor_count
        assert winding.banded_plan(8, 64, 2, 64) == winding.banded_plan(8, 64, 2, 64, sms=card)
        for sms in (card, 1, 66, wt.H100_SMS):
            for b in (1, 8, 250, 3011):
                for s in (0, 8, 128, 600, 1152, 4000):
                    for bands in (1, 2, 4, 8, 32, 128):
                        for w in (1, 32, 37, 64, 128, 300, 1500, 5000, 28861, 28947, 28948):
                            assert (winding.banded_plan(b, s, bands, w, sms=sms)
                                    == banded_launch_plan(b, s, bands, w, sms=sms)), \
                                (b, s, bands, w, sms)

    @pytest.mark.parametrize("b,s,bands,w", [(2, 600, 128, 5000), (2, 2500, 1, 4000)])
    def test_owners_beyond_one_window(self, cuda, b, s, bands, w):
        """Elements whose owners the block lists in more than one window of
        its list's capacity; each band's segments spread over all windows."""
        plan = winding.banded_plan(b, s, bands, w)
        assert plan == banded_launch_plan(b, s, bands, w, sms=plan_sms(cuda))
        assert -(-s // plan[4]) > 1
        rng = np.random.default_rng(s)
        segs = cjk.make_batch(b, s, seed=s)
        owners = rng.integers(-1, bands + 1, (b, s)).astype(np.int32)
        min_x = rng.integers(-w // 2, 4, (bands, b)).astype(np.int32)
        max_y = rng.integers(30, 130, (bands, b)).astype(np.int32)
        args = [T(a).to(cuda) for a in (segs, owners, min_x, max_y)]
        before = winding.banded_launches
        got = winding.winding_banded_batch(*args, 0.05, width=w, sample_offset=(0.25, -0.5))
        assert winding.banded_launches == before + 1
        want = winding_ref.winding_banded_batch(*args, 0.05, width=w,
                                                sample_offset=(0.25, -0.5))
        assert torch.equal(got, want) and bool((got != 0).any())

    def test_strips_are_the_per_glyph_winding(self, cuda):
        """The first 400 bucket glyphs at 64 and 32 px: the strips equal
        ``winding()`` per glyph, and ``winding()``'s plan is its parent's
        (``TestPlanOnCard`` in ``test_torch_winding.py`` holds the rest)."""
        for case in banded.cases(400):
            rec = banded.run_case(case, cuda)
            assert rec["differ"] == 0 and rec["ink"] > 0
            n = case.glyphs
            assert winding.plan(n, case.size, case.size) == wt.launch_plan(
                n, case.size, case.size, sms=plan_sms(cuda))


def plan_sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count
