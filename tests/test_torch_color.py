"""fontrx_torch's COLR v0 colour path against the JAX package's, on the CPU:
the COLR/CPAL copy, ``color_glyph_tiles``, ``composite_color_page`` (the
main path against the plain serial fold, and both against the JAX
function), ``PageRenderer.render_color`` and ``to_rgba``, the session's
colour mode, the command line's ``-m color``, and what stays unported (COLR
v1, OT-SVG and bitmap glyphs, other paint nodes: ROADMAP item 13b; the
composite mode and the ``c`` key: item 8). The card's tests hold the card to
the CPU.

The JAX package runs in a second process whose XLA:CPU generates code for
AVX at most, so that it does not contract the src-over fold's multiply-adds
into FMAs (``jax_results``); its engine is ``RasterEngine()``, the jnp route
on the CPU. The colour tiles are also held to gate 10's NumPy recipe
(``benchmarks/full_gate.py:514-570``): the oracle's coverage
(``contract=False``) folded src-over per layer.

Tolerance: 0 differing values everywhere (tiles as float32, pages and QOI
files as bytes).

The card's tests run where there is no JAX:
``python -m pytest --noconftest -m requires_cuda tests/test_torch_color.py``.
"""

import importlib.util
import logging
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from fontrx_torch.cli import main as port_cli
from fontrx_torch.engine import colorglyphs
from fontrx_torch.engine.raster import RasterEngine
from fontrx_torch.font.colr import FOREGROUND, ColrTable
from fontrx_torch.font.font import Font
from fontrx_torch.font.reader import BigEndianReader
from fontrx_torch.io.qoi import decode
from fontrx_torch.kernels import coverage
from fontrx_torch.kernels.grid import RasterGrid
from fontrx_torch.scene.interactive import InteractiveSession
from fontrx_torch.scene.layout import layout_text
from fontrx_torch.scene.page import PageRenderer

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data"
COLRTEST = str(DATA / "colrtest.ttf")
DEJAVU = str(ROOT / "fontrx_torch" / "data" / "DejaVuSans.ttf")
f32 = np.float32

# color_glyph_tiles cases: (size, tile or None, palette)
TILE_CASES = [(64, None, 0), (64, None, 1), (40, 48, 0), (32.5, 40, 1)]
# the composite's tiles: A, B and C at 32 px on 32 x 32 tiles
COMPOSITE_SIZE = 32
PAGE = (64, 48)  # width, height
# (name, slots, pen positions (x, y down)); the tiles' ink spans about 26 px
COMPOSITES = {
    "overlap": ([0, 1, 2], [[8.0, 30.0], [14.4, 34.5], [20.5, 38.6]]),
    "overlap reversed": ([2, 1, 0], [[20.5, 38.6], [14.4, 34.5], [8.0, 30.0]]),
    "same place": ([1, 0, 1, 2, 1], [[20.0, 36.0]] * 5),
    "edges": ([0, 1, 2, 0], [[-20.0, 30.0], [50.0, 20.0], [20.0, 14.0], [30.0, 60.0]]),
    "beyond the clamp": ([0, 1, 2, 1, 2], [[-90.0, 30.0], [200.0, 20.0], [20.0, -70.0],
                                           [30.0, 130.0], [10.0, 40.0]]),
    "just off": ([0, 1], [[-35.0, 30.0], [64.5, 30.0]]),
    "none": ([], np.zeros((0, 2))),
}
# the session: colrtest rows on a small page, a few events
SESSION_TEXT = "ABC\nCAB\nBCA"
SESSION_SIZE = (320, 96)
RESIZED = (256, 128)
SESSION_STEPS = ["first", "zoom out", "drag", "m", "zoom in", "t", "resize", "zoom out more"]
# the command line: (name, argv after -o); the port also gets --backend cpu
CLI_CASES = {
    f"colrtest-{size}-{pal}": ["-f", COLRTEST, "-t", "CAB\nBCA", "-s", str(size), "-m", "color",
                               "--palette", pal]
    for size, pal in ((32, "0"), (32, "1"), (48, "dark"), (32, "light"), (32, "7"),
                      (32, "nope"))
}
CLI_CASES["dejavu-mono-24"] = ["-f", DEJAVU, "-t", "Ab\ng", "-s", "24", "-m", "color"]


def gids(font, chars="ABC"):
    return [font.glyph_index(c) for c in chars]


def color_script(sess):
    """Drive a colour session: its frames, in ``SESSION_STEPS`` order."""
    out = [sess.frame()]
    for events, display in ([("scroll", -0.5, (0.1, 0.1))], False), (
            [("drag", 0.01, 0.005)], False), ([("key", "m")], False), (
            [("scroll", 0.5, (0.0, 0.2))], False), ([("key", "t")], True), (
            [("resize", *RESIZED)], False), ([("scroll", -2.0, (0.0, 0.0))], False):
        for name, *args in events:
            getattr(sess, name)(*args)
        out.append(sess.display_frame() if display else sess.frame())
    return out


def jax_results(tmp: str) -> dict:
    """Everything the tests hold the port to, from the JAX package: tiles and
    grids, composites, session frames and CLI files. Runs in the process
    that ``JAX_SCRIPT`` starts."""
    import jax.numpy as jnp

    from fontrx.cli.main import main as jax_main
    from fontrx.engine.colorglyphs import color_glyph_tiles, composite_color_page
    from fontrx.engine.raster import RasterEngine as RefEngine
    from fontrx.font.font import Font as RefFont
    from fontrx.scene.interactive import InteractiveSession as RefSession

    font = RefFont.open(COLRTEST)
    out = {}
    for i, (size, tile, pal) in enumerate(TILE_CASES):
        tiles, grids = color_glyph_tiles(font, gids(font), size, RefEngine(), palette=pal,
                                         tile=tile)
        out[f"tiles{i}"] = np.asarray(tiles)
        out[f"grids{i}"] = np.array([(g.min_x, g.max_y) for g in grids])
    tiles, grids = color_glyph_tiles(font, gids(font), COMPOSITE_SIZE, RefEngine())
    for name, (slots, pen) in COMPOSITES.items():
        out[f"composite {name}"] = composite_color_page(
            jnp.asarray(tiles), grids, np.asarray(slots, np.int64), np.asarray(pen, np.float64),
            page_h=PAGE[1], page_w=PAGE[0])
    sess = RefSession(font, SESSION_TEXT, *SESSION_SIZE, RefEngine(), mode="color")
    for step, frame in zip(SESSION_STEPS, color_script(sess)):
        out[f"session {step}"] = np.asarray(frame)
    for name, argv in CLI_CASES.items():
        path = os.path.join(tmp, f"{name}.qoi")
        assert jax_main([*argv, "-o", path]) == 0
        out[f"cli {name}"] = np.frombuffer(pathlib.Path(path).read_bytes(), np.uint8)
    return out


JAX_SCRIPT = """
import sys
import jax
import numpy as np
jax.config.update("jax_platforms", "cpu")
sys.path[:0] = ["tests", "."]
from test_torch_color import jax_results
np.savez(sys.argv[1], **jax_results(sys.argv[2]))
"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: torch on one thread, so parallel test workers do not
    spin against each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Starts ``JAX_SCRIPT`` in a process whose XLA:CPU has no FMA (AVX at
    most) and yields a function that waits for it and returns its results."""
    if importlib.util.find_spec("jax") is None:
        yield None
        return
    tmp = tmp_path_factory.mktemp("jax_color")
    out = tmp / "results.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(out), str(tmp)], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    results = {}

    def result():
        if not results:
            log, _ = proc.communicate(timeout=600)
            assert proc.returncode == 0, log.decode()[-4000:]
            results.update(np.load(out))
        return results

    yield result
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module")
def font():
    return Font.open(COLRTEST)


@pytest.fixture(scope="module")
def ref_font():
    from fontrx.font.font import Font as RefFont

    return RefFont.open(COLRTEST)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def composite_inputs(font, device="cpu"):
    tiles, grids = colorglyphs.color_glyph_tiles(font, gids(font), COMPOSITE_SIZE,
                                                 RasterEngine(device))
    return tiles, grids


# -- the COLR/CPAL copy ------------------------------------------------------------------


class TestTables:
    def test_layers_equal_jax(self, font, ref_font):
        assert font.colr.version == ref_font.colr.version == 0
        for name in ("base_gids", "first_layer", "num_layers", "layer_gids", "layer_palettes"):
            np.testing.assert_array_equal(getattr(font.colr, name), getattr(ref_font.colr, name))
        for gid in range(font.num_glyphs):
            assert font.colr.layers(gid) == ref_font.colr.layers(gid), gid
        assert [font.colr.layers(g) is not None for g in range(font.num_glyphs)].count(True) == 3

    def test_palettes_equal_jax(self, font, ref_font):
        cpal, ref = font.cpal, ref_font.cpal
        assert (cpal.num_palettes, cpal.num_entries) == (ref.num_palettes, ref.num_entries) == (
            2, 4)
        np.testing.assert_array_equal(cpal.colors, ref.colors)
        assert cpal.palette_types == ref.palette_types == (1, 2)
        for p in range(2):
            for e in range(4):
                assert cpal.color(p, e) == ref.color(p, e)
        fg = (12, 34, 56, 78)
        assert cpal.color(1, FOREGROUND, fg) == ref.color(1, 0xFFFF, fg) == fg
        for which in ("light", "dark", "LIGHT", 1):
            assert cpal.select(which) == ref.select(which)
        assert cpal.select("dark") == 1
        with pytest.raises(ValueError):
            cpal.select("dim")
        with pytest.raises(IndexError):
            cpal.color(2, 0)

    def test_b_has_a_half_alpha_layer(self, font):
        (_, p0), (_, p1) = font.colr.layers(font.glyph_index("B"))
        assert font.cpal.color(0, p0)[3] == 255 and font.cpal.color(0, p1)[3] in (127, 128)

    @pytest.mark.parametrize("palette", [0, 1])
    def test_paint_tree_equals_jax(self, font, ref_font, palette):
        fg = (10, 20, 30, 200)
        for gid in range(font.num_glyphs):
            assert font.color_paint_tree(gid, palette, fg) == ref_font.color_paint_tree(
                gid, palette, fg), gid

    def test_clip_box_is_none(self, font):
        assert all(font.colr.clip_box(g) is None for g in range(font.num_glyphs))

    def test_corrupt_colr_is_corrupted_font(self):
        import struct

        from fontrx_torch.font.reader import CorruptedFont

        bad = struct.pack(">HHIIH", 0, 1, 14, 20, 1) + struct.pack(">HHH", 1, 0, 5) + b"\0" * 4
        with pytest.raises(CorruptedFont):
            ColrTable.parse(BigEndianReader(bad))

    def test_monochrome_font_has_no_tables(self):
        dv = Font.open(DEJAVU)
        assert dv.colr is None and dv.cpal is None
        assert dv.color_paint_tree(dv.glyph_index("A")) is None


# -- the tiles -----------------------------------------------------------------------------


def gate10_tiles(ref_font, chars, size, palette=0):
    """Gate 10's NumPy recipe (``benchmarks/full_gate.py:514-570``): per
    glyph, the oracle's 2 x 2 coverage (``contract=False``) of each layer on
    the glyph's fixed tile, folded src-over with the device's constants."""
    from fontrx.kernels import oracle
    from fontrx.kernels.grid import RasterGrid as RefGrid
    from fontrx.pack.segments import glyph_segments

    out = np.zeros((len(chars), size, size, 4), f32)
    upem = ref_font.info.units_per_em
    offsets = (np.arange(2, dtype=f32) + f32(0.5)) / f32(2) - f32(0.5)
    for i, ch in enumerate(chars):
        tree = ref_font.color_paint_tree(ref_font.glyph_index(ch), palette, (0, 0, 0, 255))
        layers = [(ref_font.load_glyph_safe(n[1]), n[2][1]) for n in tree[1]]
        boxes = [g.box for g, _ in layers]
        union = (min(b.x_min for b in boxes), min(b.y_min for b in boxes),
                 max(b.x_max for b in boxes), max(b.y_max for b in boxes))
        grid = RefGrid.fixed_tile(union, size, upem, size)
        scale = f32(grid.scale)
        dst = np.zeros((size, size, 4), f32)
        for g, (r8, g8, b8, a8) in layers:
            cov = np.zeros((size, size), f32)
            for oy in offsets:
                for ox in offsets:
                    xs = ((grid.min_x + np.arange(size)).astype(f32) + ox) / scale
                    ys = ((grid.max_y - np.arange(size)).astype(f32) + oy) / scale
                    w = oracle.winding_at(glyph_segments(g), xs[None, :], ys[:, None],
                                          contract=False)
                    cov += (w != 0).astype(f32)
            cov /= 4.0
            a = cov * f32(a8 / 255.0)
            c255 = f32(255.0)
            src = np.stack([(f32(r8) / c255) * a, (f32(g8) / c255) * a, (f32(b8) / c255) * a, a],
                           axis=-1)
            dst = dst * (f32(1.0) - a[..., None]) + src
        out[i] = dst
    return out


class TestTiles:
    @pytest.mark.parametrize("case", range(len(TILE_CASES)))
    def test_equal_jax(self, font, jax_run, case):
        size, tile, palette = TILE_CASES[case]
        tiles, grids = colorglyphs.color_glyph_tiles(font, gids(font), size, RasterEngine("cpu"),
                                                     palette=palette, tile=tile)
        want = jax_run()
        assert tiles.dtype == torch.float32
        np.testing.assert_array_equal(tiles.numpy(), want[f"tiles{case}"])
        np.testing.assert_array_equal([(g.min_x, g.max_y) for g in grids], want[f"grids{case}"])

    @pytest.mark.parametrize("palette", [0, 1])
    def test_equal_gate10_oracle(self, font, ref_font, palette):
        tiles, _ = colorglyphs.color_glyph_tiles(font, gids(font), 64, RasterEngine("cpu"),
                                                 palette=palette)
        want = gate10_tiles(ref_font, "ABC", 64, palette)
        assert int((tiles.numpy() != want).sum()) == 0
        alpha = tiles[..., 3]
        assert bool(((alpha > 0) & (alpha < 1)).any()) and bool((alpha == 1).any())

    def test_one_coverage_call_over_every_layer(self, font, monkeypatch):
        calls = []
        engine = RasterEngine("cpu")
        original = engine.coverage_batch

        def spy(segments, *args, **kwargs):
            calls.append((len(segments), kwargs))
            return original(segments, *args, **kwargs)

        monkeypatch.setattr(engine, "coverage_batch", spy)
        colorglyphs.color_glyph_tiles(font, gids(font, "ABCA") + [0], 40, engine, samples=1)
        # two layers each for A, B, C and A again, and .notdef's own outline
        assert calls == [(9, dict(height=40, width=40, samples=2))]

    def test_plain_equals_main_path(self, font):
        args = (font, gids(font), 40, RasterEngine("cpu"))
        main, _ = colorglyphs.color_glyph_tiles(*args)
        plain, _ = colorglyphs.color_glyph_tiles(*args, plain=True)
        assert torch.equal(main, plain)

    def test_no_glyphs(self, font):
        tiles, grids = colorglyphs.color_glyph_tiles(font, [], 32, RasterEngine("cpu"))
        assert tiles.shape == (0, 32, 32, 4) and grids == []

    def test_color_tiles_over_background(self, font, ref_font):
        from fontrx.engine.colorglyphs import color_tiles as ref_color_tiles
        from fontrx.engine.raster import RasterEngine as RefEngine

        got = colorglyphs.color_tiles(font, gids(font), 24, RasterEngine("cpu"), palette=1,
                                      background=(13, 200, 77))
        want = ref_color_tiles(ref_font, gids(ref_font), 24, RefEngine(), palette=1,
                               background=(13, 200, 77))
        assert got.dtype == np.uint8 and got.shape == (3, 24, 24, 3)
        np.testing.assert_array_equal(got, want)


# -- the page composite ------------------------------------------------------------------


def random_composite(seed, n_tiles=3, tile=12, n=80, page=(37, 29)):
    """Random premultiplied tiles (a third of the pixels transparent, alpha 0
    or 1 now and then) and ``n`` instances piled on a small page, many off its
    edges."""
    rng = np.random.default_rng(seed)
    a = rng.random((n_tiles, tile, tile, 1), dtype=f32)
    a[rng.random(a.shape) < 0.33] = 0
    a[rng.random(a.shape) < 0.1] = 1
    rgb = rng.random((n_tiles, tile, tile, 3), dtype=f32) * a
    tiles = torch.from_numpy(np.concatenate([rgb, a], axis=-1))
    grids = [RasterGrid(width=tile, height=tile, min_x=int(m), max_y=int(y), scale=1.0)
             for m, y in rng.integers(-4, 5, (n_tiles, 2))]
    slots = rng.integers(0, n_tiles, n)
    pen = rng.uniform(-16, 44, (n, 2))
    return tiles, grids, slots, pen, page


class TestComposite:
    @pytest.mark.parametrize("name", list(COMPOSITES))
    def test_equal_jax(self, font, jax_run, name):
        slots, pen = COMPOSITES[name]
        tiles, grids = composite_inputs(font)
        got = colorglyphs.composite_color_page(
            tiles, grids, np.asarray(slots, np.int64), np.asarray(pen, np.float64),
            page_h=PAGE[1], page_w=PAGE[0])
        assert got.dtype == np.uint8 and got.shape == (PAGE[1], PAGE[0], 3)
        np.testing.assert_array_equal(got, jax_run()[f"composite {name}"])
        if name != "none":
            plain = colorglyphs.composite_color_page(
                tiles, grids, np.asarray(slots, np.int64), np.asarray(pen, np.float64),
                page_h=PAGE[1], page_w=PAGE[0], plain=True)
            np.testing.assert_array_equal(got, plain)

    def test_order_matters(self, jax_run):
        results = jax_run()
        assert (results["composite overlap"] != results["composite overlap reversed"]).any()

    def test_every_edge_clips(self, font):
        """Each instance of "edges" lies partly off one edge of the page, and
        each of "beyond the clamp" but the last has its origin clamped."""
        tiles, grids = composite_inputs(font)
        t = tiles.shape[1]
        for name, clamped in (("edges", 0), ("beyond the clamp", 4)):
            slots, pen = COMPOSITES[name]
            x0, y0 = colorglyphs.tile_origins(grids, np.asarray(slots), np.asarray(pen), t,
                                              PAGE[1], PAGE[0])
            at_clamp = (x0 == 0) | (x0 == PAGE[0] + t) | (y0 == 0) | (y0 == PAGE[1] + t)
            assert int(at_clamp.sum()) == clamped
        ink = colorglyphs.ink_boxes(tiles)
        slots, pen = COMPOSITES["edges"]
        x0, y0 = colorglyphs.tile_origins(grids, np.asarray(slots), np.asarray(pen), t, PAGE[1],
                                          PAGE[0])
        box = ink[slots]
        top, left = y0 - t + box[:, 0], x0 - t + box[:, 2]
        bottom, right = y0 - t + box[:, 1], x0 - t + box[:, 3]
        assert left[0] < 0 < right[0] and right[1] > PAGE[0] > left[1]
        assert top[2] < 0 < bottom[2] and bottom[3] > PAGE[1] > top[3]

    @pytest.mark.parametrize("seed", range(6))
    def test_rank_fold_equals_serial_fold(self, seed):
        tiles, grids, slots, pen, (w, h) = random_composite(seed)
        t = tiles.shape[1]
        x0, y0 = colorglyphs.tile_origins(grids, slots, pen, t, h, w)
        serial = colorglyphs.serial_fold(tiles, slots, x0, y0, h, w)
        ranked = colorglyphs.rank_fold(tiles, slots, x0, y0, h, w, colorglyphs.ink_boxes(tiles))
        assert torch.equal(serial.view(torch.int32), ranked.view(torch.int32))
        assert bool((serial[..., 3] > 0).any())

    def test_random_piles_are_deep(self):
        """The random cases stack many covers on a pixel, so the ranks run
        deep, and clamp many origins."""
        tiles, grids, slots, pen, (w, h) = random_composite(0)
        x0, y0 = colorglyphs.tile_origins(grids, slots, pen, tiles.shape[1], h, w)
        depth = np.zeros((h, w), int)
        for s, x, y in zip(slots, x0 - tiles.shape[1], y0 - tiles.shape[1]):
            inked = (tiles[s] != 0).any(-1).numpy()
            for r, c in zip(*np.nonzero(inked)):
                if 0 <= y + r < h and 0 <= x + c < w:
                    depth[y + r, x + c] += 1
        assert depth.max() >= 6
        t = tiles.shape[1]
        assert int(((x0 == 0) | (x0 == w + t) | (y0 == 0) | (y0 == h + t)).sum()) >= 10

    def test_ink_boxes(self):
        tiles = torch.zeros((3, 8, 8, 4))
        tiles[0, 2, 3, 1] = 0.5
        tiles[0, 6, 1, 3] = 0.25
        tiles[2] = 1.0
        np.testing.assert_array_equal(colorglyphs.ink_boxes(tiles),
                                      [[2, 7, 1, 4], [0, 0, 0, 0], [0, 8, 0, 8]])

    def test_no_instances_is_the_background(self, font):
        tiles, grids = composite_inputs(font)
        page = colorglyphs.composite_color_page(tiles, grids, [], np.zeros((0, 2)), page_h=5,
                                                page_w=7, background=(1, 2, 3))
        assert page.shape == (5, 7, 3) and (page == [1, 2, 3]).all()


# -- render_color, to_rgba, the session ----------------------------------------------------


def session(font, device="cpu"):
    return InteractiveSession(font, SESSION_TEXT, *SESSION_SIZE, device, mode="color")


class TestSession:
    def test_frames_equal_jax(self, font, jax_run):
        frames = color_script(session(font))
        want = jax_run()
        for step, got in zip(SESSION_STEPS, frames, strict=True):
            np.testing.assert_array_equal(got, want[f"session {step}"], err_msg=step)
        assert frames[0].shape == (SESSION_SIZE[1], SESSION_SIZE[0], 3)
        assert frames[5].shape == (SESSION_SIZE[1], SESSION_SIZE[0], 4)
        assert frames[-1].shape == (RESIZED[1], RESIZED[0], 3)
        assert len({f.tobytes() for f in frames}) >= 5

    def test_m_and_d_change_nothing(self, font):
        sess = session(font)
        first = sess.frame()
        sess.key("m")
        sess.key("d")
        assert np.array_equal(sess.frame(), first)

    def test_tiles_are_cached_per_zoom(self, font, monkeypatch):
        sess = session(font)
        calls = []
        original = colorglyphs.color_glyph_tiles

        def spy(*args, **kwargs):
            calls.append(args[2])
            return original(*args, **kwargs)

        monkeypatch.setattr("fontrx_torch.scene.page.color_glyph_tiles", spy)
        sess.frame()
        sess.drag(0.02, 0.0)
        sess.frame()
        sess.scroll(-0.5, (0.0, 0.0))
        sess.frame()
        assert len(calls) == 2

    def test_render_color_plain_equals_main_path(self, font):
        sess = session(font)
        sess.scroll(-1.5, (0.0, 0.0))
        main = sess.frame()
        assert np.array_equal(sess.renderer.render_color(sess.view, plain=True), main)
        assert (main != 255).any()

    def test_to_rgba_of_a_colour_page(self, font):
        from fontrx.scene.page import PageRenderer as RefRenderer

        page = session(font).frame()
        got = PageRenderer.to_rgba(page)
        np.testing.assert_array_equal(got, RefRenderer.to_rgba(page))
        np.testing.assert_array_equal(PageRenderer.to_rgba(torch.from_numpy(page), True), got)

    def test_tile_size_equals_jax(self, font, ref_font):
        from fontrx.engine.raster import RasterEngine as RefEngine
        from fontrx.scene.layout import layout_text as ref_layout
        from fontrx.scene.page import PageRenderer as RefRenderer

        for f, text in ((font, SESSION_TEXT), (Font.open(DEJAVU), "Wg")):
            ref = type(ref_font).open(COLRTEST if f is font else DEJAVU)
            port = PageRenderer(f, layout_text(f, text), 100, 100, "cpu")
            want = RefRenderer(ref, ref_layout(ref, text), 100, 100, RefEngine())
            for ppu in (0.01, 0.1, 0.5, 1.3, 4.0):
                assert port._tile_size(ppu) == want._tile_size(ppu)

    def test_composite_mode_and_c_key_name_item_8(self, font):
        with pytest.raises(NotImplementedError, match=r"ROADMAP item 8\b"):
            InteractiveSession(font, SESSION_TEXT, *SESSION_SIZE, "cpu", mode="composite")
        sess = session(font)
        for call in (sess.cycle_mode, lambda: sess.key("c")):
            with pytest.raises(NotImplementedError, match=r"ROADMAP item 8\b"):
                call()


# -- the command line ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_color")
    out = {}
    for name, argv in CLI_CASES.items():
        assert port_cli.main([*argv, "--backend", "cpu", "-o", str(tmp / f"{name}.qoi")]) == 0
        out[name] = (tmp / f"{name}.qoi").read_bytes()
    return out


# the values a standard QOI decoder reads wrong in each file (the encoder's
# index-slot fault, ROADMAP.md queue 3); every other case reads right
SPEC_MISREAD = {}


class TestCli:
    @pytest.mark.parametrize("name", list(CLI_CASES))
    def test_bytes_equal_jax(self, cli_files, jax_run, name):
        assert cli_files[name] == jax_run()[f"cli {name}"].tobytes()

    @pytest.mark.parametrize("name", list(CLI_CASES))
    def test_standard_decoder(self, cli_files, name):
        from fontrx.io.qoi import decode as ref_decode

        data = cli_files[name]
        strict = decode(data, strict=True)
        np.testing.assert_array_equal(strict, ref_decode(data))
        assert int((strict != decode(data)).sum()) == SPEC_MISREAD.get(name, 0)

    def test_palettes_differ(self, cli_files):
        p0, p1 = (decode(cli_files[f"colrtest-32-{p}"]) for p in "01")
        assert p0.shape == p1.shape and (p0 != p1).any()
        dark32 = [a if a != "48" else "32" for a in CLI_CASES["colrtest-48-dark"]]
        assert cli_files["colrtest-32-1"] == port_cli_bytes(dark32)
        assert cli_files["colrtest-32-light"] == cli_files["colrtest-32-0"]

    @pytest.mark.parametrize("name,warning", [
        ("colrtest-32-7", "palette 7 out of range"), ("colrtest-32-nope", "unknown palette"),
        ("dejavu-mono-24", "renders the monochrome outlines")])
    def test_fallbacks_warn(self, cli_files, caplog, name, warning, tmp_path):
        with caplog.at_level(logging.WARNING, logger="fontrx_torch.Main"):
            assert port_cli.main([*CLI_CASES[name], "--backend", "cpu", "-o",
                                  str(tmp_path / "a.qoi")]) == 0
        assert warning in caplog.text
        if name != "dejavu-mono-24":
            assert cli_files[name] == cli_files["colrtest-32-0"]

    def test_launches_nothing_on_the_cpu(self, cli_files):
        before = coverage.launches
        port_cli_bytes(CLI_CASES["colrtest-32-0"])
        assert coverage.launches == before


def port_cli_bytes(argv, *more) -> bytes:
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "a.qoi")
        assert port_cli.main([*argv, *more, "--backend", "cpu", "-o", path]) == 0
        return pathlib.Path(path).read_bytes()


# -- what is not ported --------------------------------------------------------------------


class TestNotPorted:
    @pytest.mark.parametrize("fixture", ["colrv1test", "svgtest", "sbixtest", "cbdttest"])
    def test_cli_raises_13b(self, fixture, tmp_path):
        with pytest.raises(NotImplementedError, match=r"ROADMAP item 13b"):
            port_cli.main(["-f", str(DATA / f"{fixture}.ttf"), "-t", "AB", "-s", "16", "-m",
                           "color", "--backend", "cpu", "-o", str(tmp_path / "a.qoi")])
        assert not (tmp_path / "a.qoi").exists()

    def test_colr_v1_table_raises(self):
        with pytest.raises(NotImplementedError, match=r"COLR version 1.*ROADMAP item 13b"):
            Font.open(DATA / "colrv1test.ttf").colr

    def test_session_raises_13b(self):
        sess = InteractiveSession(Font.open(DATA / "colrv1test.ttf"), "AB", 64, 32, "cpu",
                                  mode="color")
        with pytest.raises(NotImplementedError, match=r"ROADMAP item 13b"):
            sess.frame()

    @pytest.mark.parametrize("tree", [
        ("composite", 3, ("layers", []), ("layers", [])),
        ("layers", [("glyph", 4, ("linear", (0, 0, 1, 1), 0, []), None)]),
        ("layers", [("glyph", 4, ("solid", (1, 2, 3, 4)), (1.0, 0.0, 0.0, 1.0, 5.0, 0.0))]),
        ("layers", [("alpha", 0.5, ("glyph", 4, ("solid", (1, 2, 3, 4)), None))]),
    ], ids=["composite", "gradient", "transform", "alpha"])
    def test_other_paints_raise_13b(self, font, monkeypatch, tree):
        monkeypatch.setattr(font, "color_paint_tree", lambda *args: tree)
        with pytest.raises(NotImplementedError, match=r"ROADMAP item 13b"):
            colorglyphs.color_glyph_tiles(font, [1], 16, RasterEngine("cpu"))


# -- on the card ---------------------------------------------------------------------------


@pytest.mark.requires_cuda
class TestOnCard:
    @pytest.mark.parametrize("size,tile", [(64, None), (100.5, 128)])
    def test_tiles_equal_cpu(self, font, cuda, size, tile):
        before = coverage.launches
        got, _ = colorglyphs.color_glyph_tiles(font, gids(font, "ABCBA"), size,
                                               RasterEngine(cuda), tile=tile)
        assert coverage.launches == before + 1
        want, _ = colorglyphs.color_glyph_tiles(font, gids(font, "ABCBA"), size,
                                                RasterEngine("cpu"), tile=tile)
        assert got.device.type == "cuda" and torch.equal(got.cpu(), want)

    @pytest.mark.parametrize("seed", range(3))
    def test_rank_fold_equals_serial_fold(self, cuda, seed):
        tiles, grids, slots, pen, (w, h) = random_composite(seed, tile=40, n=300, page=(200, 120))
        tiles = tiles.to(cuda)
        x0, y0 = colorglyphs.tile_origins(grids, slots, pen, tiles.shape[1], h, w)
        serial = colorglyphs.serial_fold(tiles, slots, x0, y0, h, w)
        ranked = colorglyphs.rank_fold(tiles, slots, x0, y0, h, w, colorglyphs.ink_boxes(tiles))
        assert torch.equal(serial.view(torch.int32), ranked.view(torch.int32))

    def test_session_equals_cpu(self, font, cuda):
        before = coverage.launches
        got = color_script(session(font, cuda))
        assert coverage.launches - before == 5  # the first frame, the zooms and the resize
        for step, g, w in zip(SESSION_STEPS, got, color_script(session(font)), strict=True):
            np.testing.assert_array_equal(g, w, err_msg=step)

    @pytest.mark.parametrize("name", list(CLI_CASES))
    def test_cli_equals_cpu(self, cuda, name, tmp_path):
        before = coverage.launches
        assert port_cli.main([*CLI_CASES[name], "-o", str(tmp_path / "g.qoi")]) == 0
        assert coverage.launches == before + 1
        assert (tmp_path / "g.qoi").read_bytes() == port_cli_bytes(CLI_CASES[name])
