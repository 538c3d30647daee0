"""fontrx_torch's edit path against the JAX package's, on the CPU: UAX#29
grapheme clusters and their tables, ``LazyInstances``, the paragraph-cached
``IncrementalLayoutEngine`` with its dirty lines, and the interactive
session's ``char_input`` / ``backspace`` with the dirty-strip splice, frame
by frame on one edit script on a narrow page (the v2 route), a wide one
(K7's route) and a page shorter than the band; each spliced page against a
fresh session's; and the script on the card, with its launches.

Tolerance everywhere: 0 differing pixels and equal arrays. Layout options
stay at their defaults (the port's ``layout_text`` raises on the others).
A spliced page equals a fresh one at the first view. After a zoom, in or
out, a band's rows may differ from the full page's, in both packages
(``ROADMAP.md`` queue 3: the band's 128-row strips start at its own first
row): there a spliced page is held to the JAX package's spliced page, and
both packages' counts against a fresh page are printed and held equal.

The card's tests run where there is no JAX:
``python -m pytest --noconftest -m requires_cuda tests/test_torch_edit.py``.
"""

import pathlib

import numpy as np
import pytest
import torch

from fontrx_torch.font import _uax29_data, uax29
from fontrx_torch.font.font import Font
from fontrx_torch.kernels import page
from fontrx_torch.scene.incremental import IncrementalLayoutEngine
from fontrx_torch.scene.interactive import InteractiveSession, drop_clusters
from fontrx_torch.scene.layout import Instance, LazyInstances, layout_text
from fontrx_torch.scene.page import PageRenderer
from fontrx_torch.scene.transform import ViewTransform

ROOT = pathlib.Path(__file__).resolve().parents[1]
FONT = ROOT / "fontrx_torch" / "data" / "DejaVuSans.ttf"

# the strings of tests/test_uax29.py and of
# tests/test_incremental.py::TestBackspaceClusters: CR LF, a trailing LF,
# Hangul, emoji ZWJ sequences, skin tones, flags, combining marks, prepend
CLUSTER_TEXTS = [
    "", "abc", "a\r\nb", "a\n\rb", "éé", "ẹ́",
    "한", "한", "각a",
    "\U0001F469‍\U0001F469‍\U0001F466", "\U0001F44D\U0001F3FB", "a‍b",
    "\U0001F1FA\U0001F1F8\U0001F1FA\U0001F1F8", "\U0001F1FA\U0001F1F8\U0001F1FA",
    "؀١", "กำ", "héllo w‍orld",
    "a\r\n\rb\n", "؀١٢ กำ",
    "hello world", "para one\npara two", "ends with lf\n", "crlf pair\r\n",
    "ȩ́ stack", "fam: \U0001F468‍\U0001F469‍\U0001F467",
    "flags \U0001F1EB\U0001F1F7\U0001F1E9\U0001F1EA", "\n\n\n", "한글 끝",
]
BACKSPACE_N = [1, 2, 3, 50]

# two lines, so that the appended text is on the page at the first view
TEXT = "Paragraph 0: quick brown foxes office 0!\nParagraph 1: quick"
PAGES = {"v2": (480, 320), "k7": (1100, 320)}  # taller than the band; either route
SHORT = (320, 200)                              # shorter than the band: always full
ZOOM_IN = (0.25, (0.0, -0.9))  # keeps line 1 on the narrow page
ZOOM_OUT = (-8.0, (0.0, 0.0))  # the stress page's zoom
# (what, events); a frame after each
SCRIPT = [
    ("first", ()),
    ("x", (("char_input", "x"),)),
    ("yz!", (("char_input", "yz!"),)),
    ("backspace 2", (("backspace", 2),)),
    ("overhang", (("char_input", " QjÂÇ"),)),
    ("m, edit", (("key", "m"), ("char_input", "m"))),
    ("m off", (("key", "m"),)),
    ("m off, edit", (("char_input", "n"),)),
    ("new paragraph", (("char_input", "\nnew paragraph"),)),
    ("backspace 30", (("backspace", 30),)),
    ("repeated", ()),
    ("zoom in", (("scroll", *ZOOM_IN),)),
    ("zoom in, Q", (("char_input", "Q"),)),
    ("zoom in, backspace", (("backspace", 1),)),
    ("zoom out", (("scroll", *ZOOM_OUT),)),
    ("zoom out, o", (("char_input", "o"),)),
    ("zoom out, backspace", (("backspace", 1),)),
]
STEPS = [what for what, _ in SCRIPT]
ZOOMED = STEPS.index("zoom in")  # from here on, splice != fresh is possible
SHORT_SCRIPT = SCRIPT[:4]

# texts through the engine, in turn: appends, backspaces, a backspace across
# paragraphs, added paragraphs, an emptied text and the edge texts
BASE = ("The quick brown fox jumps over the lazy dog.\n"
        "Waltz, bad nymph, for quick jigs vex! 0123456789\n"
        "\n"
        "office flag traffic afflict\n"
        "final paragraph, Voilà: café naïve")
ENGINE_TEXTS = [BASE, BASE + "t", BASE + "ty", BASE + "typ", BASE + "ty", BASE[:-40],
                BASE[:-40] + "\n", BASE[:-40] + "\nnew para", BASE + "\n\nmore\nlines", "",
                "rebuilt from empty", "\n", "\n\n\n", "a\n", "\na", "a", BASE]


@pytest.fixture(scope="module")
def font():
    return Font.open(FONT)


@pytest.fixture(scope="module")
def ref_font():
    from fontrx.font.font import Font as RefFont

    return RefFont.open(str(FONT))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small pages: torch on one thread, so parallel test workers do not spin
    against each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def take_frame(sess):
    """One frame: ``(page as a host array, dirty band, path)``. The dirty
    band is ``_dirty_band`` of the span the frame consumes, or that span
    itself when it is ``"all"`` or ``()``. The path is told from the
    session's cache around the frame: a ``"cached"`` or ``"offscreen"``
    frame keeps the cached page; a ``"band"`` frame replaces it under the
    same view state, MSAA and debug off, over a band of rows; any other
    frame is ``"full"``."""
    pending, state, cached = sess._pending_dirty, sess._page_state, sess._page_dev
    band = sess._dirty_band(*pending) if pending not in ("all", ()) else pending
    page_host = np.asarray(sess.frame())
    if sess._page_dev is cached:
        path = "cached" if pending == () else "offscreen"
    elif (band not in (None, "all", (), (0, 0)) and sess._page_state == state
          and not sess.msaa and not sess.debug):
        path = "band"
    else:
        path = "full"
    return page_host, band, path


def run_script(sess, script=SCRIPT):
    """Drive a session through ``script``: per step ``(what, page as a host
    array, dirty band, text, path)`` (``take_frame``)."""
    out = []
    for what, events in script:
        for name, *args in events:
            getattr(sess, name)(*args)
        page_host, band, path = take_frame(sess)
        out.append((what, page_host, band, sess.text, path))
    return out


def fresh_page(font, text, size, view, msaa=False):
    """A new session's first page of ``text`` at ``view``."""
    sess = InteractiveSession(font, text, *size, "cpu", msaa=msaa)
    sess.view = view
    return sess.frame()


def assert_layout_equal(a, b):
    assert list(a.slot_gids) == list(b.slot_gids)
    assert list(a.slot_chars) == list(b.slot_chars)
    for name in ("segments", "seg_counts", "boxes", "advance_widths"):
        np.testing.assert_array_equal(getattr(a.batch, name), np.asarray(getattr(b.batch, name)))
    assert a.batch.capacity == b.batch.capacity
    assert len(a.instances) == len(b.instances)
    for ia, ib in zip(a.instances, b.instances):
        assert (ia.glyph_slot, ia.x, ia.y) == (ib.glyph_slot, ib.x, ib.y)
    for x, y in zip(a.instance_arrays(), b.instance_arrays()):
        np.testing.assert_array_equal(x, y)
    assert (a.width, a.height) == (b.width, b.height)


# -- (a) grapheme clusters ------------------------------------------------------------


class TestClusters:
    @pytest.mark.parametrize("text", CLUSTER_TEXTS)
    def test_clusters_equal_the_original(self, text):
        from fontrx.font import uax29 as ref

        assert uax29.grapheme_clusters(text) == ref.grapheme_clusters(text)
        assert uax29.cluster_positions(text) == ref.cluster_positions(text)

    @pytest.mark.parametrize("table", ["CLASSES", "GCB_STARTS", "GCB_IDS", "EXTPICT"])
    def test_table_equals_the_original(self, table):
        from fontrx.font import _uax29_data as ref

        assert getattr(_uax29_data, table) == getattr(ref, table)

    def test_classes_over_code_point_ranges(self):
        from fontrx.font import uax29 as ref

        cps = [*range(0, 0x3400), *range(0xA000, 0x11000), *range(0x1F000, 0x1FB00),
               0xE0001, 0xE0020, 0xE0100, 0x10FFFF, -1, 0x110000]
        assert [uax29.gcb_class(c) for c in cps] == [ref.gcb_class(c) for c in cps]

    @pytest.mark.parametrize("n", BACKSPACE_N)
    @pytest.mark.parametrize("text", CLUSTER_TEXTS)
    def test_drop_clusters(self, ref_font, text, n):
        """The session's backspace drops the last ``n`` clusters of the whole
        text, as the JAX package's session does."""
        from fontrx.engine.raster import RasterEngine
        from fontrx.scene.interactive import InteractiveSession as RefSession

        clusters = uax29.grapheme_clusters(text)
        want = "".join(clusters[:-n]) if n < len(clusters) else ""
        assert drop_clusters(text, n) == want
        ref = RefSession(ref_font, text, 64, 64, RasterEngine())
        ref.backspace(n)
        assert ref.text == want

    @pytest.mark.parametrize("text", ["hello world", "para one\npara two", "ends with lf\n",
                                      "crlf pair\r\n", "a\r\nb", "\n\n\n", ""])
    def test_session_backspace(self, font, text):
        sess = InteractiveSession(font, text, 64, 64, "cpu")
        sess.backspace(0)
        assert sess.text == text
        sess.backspace(2)
        assert sess.text == drop_clusters(text, 2)
        assert_layout_equal(sess.layout, layout_text(font, sess.text))


    def test_unported_character_leaves_the_session(self, font):
        sess = InteractiveSession(font, TEXT, *SHORT, "cpu")
        first = sess.frame()
        with pytest.raises(NotImplementedError):
            sess.char_input("\u05d0")  # Hebrew: the layout's plain path stops below U+0590
        assert sess.text == TEXT
        page_host, _, path = take_frame(sess)
        np.testing.assert_array_equal(page_host, first)
        assert path == "cached"


# -- (b) LazyInstances and the incremental layout ---------------------------------------


class TestLazyInstances:
    def test_behaves_as_the_original(self):
        from fontrx.scene.layout import LazyInstances as RefLazy

        rng = np.random.default_rng(19)
        slots = rng.integers(0, 40, 37).astype(np.int32)
        offs = rng.normal(size=(37, 2)) * 1e4
        got, want = LazyInstances(slots, offs), RefLazy(slots, offs)
        assert len(got) == len(want) == 37

        def fields(i):
            return (i.glyph_slot, i.x, i.y)

        for k in (0, 5, 36, -1, -37):
            assert fields(got[k]) == fields(want[k]) and isinstance(got[k], Instance)
        for sl in (slice(None), slice(3, 30, 4), slice(-5, None), slice(10, 2, -3)):
            assert list(map(fields, got[sl])) == list(map(fields, want[sl]))
        assert list(map(fields, got)) == list(map(fields, want))
        with pytest.raises(IndexError):
            got[37]

    def test_page_accepts_it(self, font):
        """``PageRenderer`` builds the same stream and offsets from a merged
        layout (``LazyInstances``) as from ``layout_text``'s list."""
        text = BASE + "\n" + TEXT
        lazy = IncrementalLayoutEngine(font).layout(text)
        plain = layout_text(font, text)
        assert isinstance(lazy.instances, LazyInstances) and isinstance(plain.instances, list)
        view = ViewTransform.init(font.info.units_per_em, 480, 320).zoomed(-2.0, (0.1, 0.1))
        a = PageRenderer(font, lazy, 480, 320, "cpu")
        b = PageRenderer(font, plain, 480, 320, "cpu")
        for x, y in zip(a._compact_instances(), b._compact_instances()):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        for x, y in zip(a.page_inputs(view), b.page_inputs(view)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert torch.equal(a.render_direct(view), b.render_direct(view))


@pytest.fixture(scope="module")
def engine_runs(font, ref_font):
    """Both packages' engines through ``ENGINE_TEXTS``: per text, (port
    layout, JAX layout, port dirty lines, JAX dirty lines)."""
    from fontrx.scene.incremental import IncrementalLayoutEngine as RefEngine

    port, ref = IncrementalLayoutEngine(font), RefEngine(ref_font)
    out = []
    for text in ENGINE_TEXTS:
        out.append((port.layout(text), ref.layout(text), port.consume_dirty_lines(),
                    ref.consume_dirty_lines()))
    return out


class TestIncrementalLayout:
    @pytest.mark.parametrize("k", range(len(ENGINE_TEXTS)))
    def test_edit_script(self, font, engine_runs, k):
        """Each state of the script: the merge equals ``layout_text`` on the
        whole text and the JAX package's engine, field for field, and the
        dirty lines equal the JAX package's."""
        got, want, lines, ref_lines = engine_runs[k]
        assert_layout_equal(got, layout_text(font, ENGINE_TEXTS[k]))
        assert_layout_equal(got, want)
        assert lines == ref_lines
        assert (lines is None) == (k == 0)

    def test_dirty_lines_of_the_script(self, engine_runs):
        lines = [r[2] for r in engine_runs]
        assert lines[1] == (4, 5)    # an append dirties the last paragraph
        assert lines[5] == (3, 5)    # a backspace across paragraphs
        assert lines[8] == (3, 8)    # a changed paragraph and three added after it
        assert lines[16] == (0, 5)   # from "a" back to BASE

    def test_paragraph_cache(self, font):
        eng = IncrementalLayoutEngine(font)
        eng.layout(BASE)
        n0 = len(eng._cache)
        first = eng._cache[("office flag traffic afflict", ())]
        eng.layout(BASE + "!")  # only the last paragraph is laid out again
        assert len(eng._cache) == n0 + 1
        assert eng._cache[("office flag traffic afflict", ())] is first

    def test_lru_bound(self, font, monkeypatch):
        monkeypatch.setattr(IncrementalLayoutEngine, "_CACHE_SIZE", 4)
        eng = IncrementalLayoutEngine(font)
        for i in range(10):
            eng.layout(f"para {i}")
        assert len(eng._cache) <= 4
        assert_layout_equal(eng.layout("para 0"), layout_text(font, "para 0"))

    @pytest.mark.parametrize("options", [{"underline": True}, {"vertical": True},
                                         {"pad_batch_to": 8}, {"kern": True},
                                         {"line_height": 3000}])
    def test_unported_options_raise(self, font, options):
        """The merge and the fallback (no merge) both reach ``layout_text``,
        which raises on every option away from its default."""
        eng = IncrementalLayoutEngine(font, **options)
        with pytest.raises(NotImplementedError):
            eng.layout("ab\ncd")
        eng._mergeable = False
        with pytest.raises(NotImplementedError):
            eng.layout("ab\ncd")


# -- (c) the session against the JAX package's, frame by frame --------------------------


@pytest.fixture(scope="module")
def jax_runs(ref_font):
    """The JAX package's sessions through the script (its Pallas kernels in
    interpret mode on the CPU), each page once, and the short page."""
    from fontrx.engine.raster import RasterEngine
    from fontrx.scene.interactive import InteractiveSession as RefSession

    runs = {name: run_script(RefSession(ref_font, TEXT, *size, RasterEngine()))
            for name, size in PAGES.items()}
    runs["short"] = run_script(RefSession(ref_font, TEXT, *SHORT, RasterEngine()), SHORT_SCRIPT)
    return runs


def port_run(font, size, script=SCRIPT, device="cpu"):
    """The port's session through ``script``: the steps (``run_script``),
    and per step the view and MSAA state its frame was rendered under."""
    sess = InteractiveSession(font, TEXT, *size, device)
    states = []
    orig = sess.frame

    def frame():
        page_host = orig()
        states.append((sess.view, sess.msaa))
        return page_host

    sess.frame = frame
    return run_script(sess, script), states


@pytest.fixture(scope="module")
def port_runs(font):
    runs = {name: port_run(font, size) for name, size in PAGES.items()}
    runs["short"] = port_run(font, SHORT, SHORT_SCRIPT)
    return runs


CASES = [(name, k) for name in PAGES for k in range(len(SCRIPT))]
CASES += [("short", k) for k in range(len(SHORT_SCRIPT))]


class TestAgainstJax:
    @pytest.mark.parametrize("name,k", CASES, ids=[f"{n}-{STEPS[k]}" for n, k in CASES])
    def test_frame(self, jax_runs, port_runs, name, k):
        """The page, the dirty band and the path of every step equal the JAX
        package's."""
        what, want, want_band, want_text, want_path = jax_runs[name][k]
        got_what, got, got_band, got_text, got_path = port_runs[name][0][k]
        assert what == got_what == STEPS[k] and got_text == want_text
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert (got_band, got_path) == (want_band, want_path)

    def test_the_script_takes_each_path(self, port_runs):
        """The narrow page bands at the first view and after the zoom-in;
        the wide page only after the zoom-out (at the first view one of its
        lines is taller than the band); the short page never bands."""
        paths = {name: [s[4] for s in run[0]] for name, run in port_runs.items()}
        v2, k7 = paths["v2"], paths["k7"]
        assert v2[STEPS.index("x")] == v2[STEPS.index("zoom in, Q")] == "band"
        assert {"band", "full", "offscreen", "cached"} <= set(v2[:ZOOMED])
        assert v2[STEPS.index("m, edit")] == "full"  # MSAA: the full render
        assert "band" not in k7[:STEPS.index("zoom out")]
        assert k7[STEPS.index("zoom out, o")] == "band"
        assert "band" not in paths["short"]
        for name in PAGES:
            bands = [s[2] for s in port_runs[name][0] if s[4] == "band"]
            assert bands and all(rows == 256 for _, rows in bands)


class TestZoomedMsaa:
    def test_against_jax_and_the_oracle(self, font, ref_font, capsys):
        """The MSAA page of the wide page after ``ZOOM_IN``: where the JAX
        package's page (its kernel in interpret mode on the CPU, where XLA
        may fuse multiply-adds) differs from the port's, the port's pixel is
        the oracle's (``contract=False``) over the four samples. The count
        is printed."""
        from fontrx.engine.raster import RasterEngine
        from fontrx.scene.interactive import InteractiveSession as RefSession
        from fontrx.scene.transform import ViewTransform as RefView
        from fontrx_torch.kernels import oracle, page_ref

        text, (w, h) = TEXT + "xQm", PAGES["k7"]
        sess = InteractiveSession(font, text, w, h, "cpu", msaa=True)
        sess.view = sess.view.zoomed(*ZOOM_IN)
        got = sess.frame()
        ref = RefSession(ref_font, text, w, h, RasterEngine(), msaa=True)
        ref.view = RefView(sess.view.scale, sess.view.offset, sess.view.aspect_ratio)
        differ = np.argwhere(got != np.asarray(ref.frame()))
        q = page_ref.transform_segments(*sess.renderer.page_inputs(sess.view)).numpy()
        for r, c in differ:
            inside = sum(
                int(oracle.winding_at(q, np.float32([[np.float32(c) + np.float32(ox)]]),
                                      np.float32([[np.float32(h - 1 - r) + np.float32(oy)]]),
                                      contract=False)[0, 0] != 0)
                for oy, oxs in page_ref.msaa_lattice() for ox in oxs)
            assert got[r, c] == inside * 255 // 4
        with capsys.disabled():
            print(f"\nk7 MSAA after scroll{ZOOM_IN}: {len(differ)} pixels differ from the JAX "
                  f"package's interpret run, each equal to the oracle: {differ.tolist()}")


# -- (d) spliced pages against fresh ones, (e) after a zoom ---------------------------


FRESH_CASES = [(name, k) for name in PAGES for k in range(ZOOMED)]
FRESH_CASES += [("short", k) for k in range(len(SHORT_SCRIPT))]


class TestSpliceEqualsFresh:
    @pytest.mark.parametrize("name,k", FRESH_CASES,
                             ids=[f"{n}-{STEPS[k]}" for n, k in FRESH_CASES])
    def test_frame_equals_a_fresh_session(self, font, port_runs, name, k):
        """At the first view every page (spliced, cached or full) equals a
        fresh session's for its text and view."""
        size = SHORT if name == "short" else PAGES[name]
        steps, states = port_runs[name]
        view, msaa = states[k]
        np.testing.assert_array_equal(steps[k][1], fresh_page(font, steps[k][3], size, view, msaa))

    @pytest.mark.parametrize("name", list(PAGES))
    def test_zoomed_splice_is_recorded(self, font, ref_font, jax_runs, port_runs, name,
                                       capsys):
        """After the zoom-in and the zoom-out, a band's rows may differ from
        the full page's in both packages: per step, the port's page equals
        the JAX package's (``test_frame``), and its count against a fresh
        port page equals the JAX package's against a fresh JAX page. The
        counts are printed, not asserted."""
        from fontrx.engine.raster import RasterEngine
        from fontrx.scene.interactive import InteractiveSession as RefSession
        from fontrx.scene.transform import ViewTransform as RefView

        steps, states = port_runs[name]
        counts = []
        for k in range(ZOOMED, len(SCRIPT)):
            (_, _, _, text, path), (view, msaa) = steps[k], states[k]
            fresh = fresh_page(font, text, PAGES[name], view, msaa)
            ref = RefSession(ref_font, text, *PAGES[name], RasterEngine(), msaa=msaa)
            ref.view = RefView(view.scale, view.offset, view.aspect_ratio)
            ref_fresh = np.asarray(ref.frame())
            np.testing.assert_array_equal(fresh, ref_fresh)
            got = int((steps[k][1] != fresh).sum())
            assert got == int((jax_runs[name][k][1] != ref_fresh).sum())
            counts.append((STEPS[k], path, got))
            if path == "full":
                assert got == 0  # a full render is a fresh page
        with capsys.disabled():
            print(f"\n{name} {PAGES[name]} after scroll{ZOOM_IN} and scroll{ZOOM_OUT}: (step, "
                  f"path, pixels differing from a fresh page, in both packages) {counts}")


# -- on the card ---------------------------------------------------------------------


@pytest.mark.requires_cuda
class TestOnCard:
    @pytest.mark.parametrize("name", [*PAGES, "short"])
    def test_script_equals_the_cpu_session(self, font, cuda, port_runs, name):
        """Every page equals the CPU session's; a band frame is one launch of
        the page kernel with 256 rows, a full frame one launch, a cached or
        off-screen frame none."""
        size, script = (SHORT, SHORT_SCRIPT) if name == "short" else (PAGES[name], SCRIPT)
        sess = InteractiveSession(font, TEXT, *size, cuda)
        want_steps = port_runs[name][0]
        for k, (what, events) in enumerate(script):
            for event, *args in events:
                getattr(sess, event)(*args)
            before = (page.launches, page.msaa_launches)
            got, band, path = take_frame(sess)
            torch.cuda.synchronize()
            launched = (page.launches - before[0], page.msaa_launches - before[1])
            np.testing.assert_array_equal(got, want_steps[k][1], err_msg=what)
            assert (band, path) == (want_steps[k][2], want_steps[k][4]), what
            want = {"band": (1, 0), "full": (0, 1) if sess.msaa else (1, 0),
                    "cached": (0, 0), "offscreen": (0, 0)}[path]
            assert launched == want, what
            if path == "band":
                assert band[1] == 256
