"""fontrx_torch's ``InteractiveSession`` (direct mode) against the JAX
package's on one event script (scroll, drag, the ``m``, ``d`` and ``t``
keys, a resize and a repeated frame) on a small page, on the CPU; its
layout against ``IncrementalLayoutEngine``'s; the view-state cache; the
pipeline option; every branch that is not ported; and the session on the
card. Tolerance: 0 differing pixels.

The card's tests run where there is no JAX:
``python -m pytest --noconftest -m requires_cuda tests/test_torch_interactive.py``.
"""

import numpy as np
import pytest
import torch

from fontrx_torch.kernels import page
from fontrx_torch.scene.interactive import EventState, InteractiveSession
from fontrx_torch.scene.layout import layout_text
from tests.test_torch_page import FONT, TEXT

SIZE = (480, 128)     # the narrow route (the v2 sweep; MSAA as four passes)
RESIZED = (1100, 128)  # the wide route (K7; MSAA as K8's pairs)
CONFIG5_TEXT = "\n".join(
    "The quick brown fox jumps over the lazy dog 0123456789" for _ in range(20))


def script(sess):
    """Drive a session through the event script: ``[(what, frame)]``, each
    frame a uint8 host array (RGBA from ``display_frame``)."""
    out = [("first", sess.frame())]

    def step(what, *events, display=False):
        for name, *args in events:
            getattr(sess, name)(*args)
        out.append((what, sess.display_frame() if display else sess.frame()))

    step("zoom out", ("scroll", -0.5, (0.1, 0.1)))
    step("drag", ("drag", 0.01, 0.005))
    step("m", ("key", "m"))
    step("m, zoom in", ("scroll", 0.5, (0.1, 0.1)))
    step("m, d", ("key", "d"))
    step("d", ("key", "m"))
    step("t", ("key", "t"), ("key", "d"), display=True)
    step("repeated", display=True)
    step("t again", ("key", "t"), display=True)
    step("resize", ("resize", *RESIZED))
    step("resize, m", ("key", "m"))
    step("resize, m, zoom out", ("scroll", -8.0, (0.0, 0.0)))
    step("resize, drag", ("key", "m"), ("drag", -0.02, 0.01))
    return out


STEPS = ["first", "zoom out", "drag", "m", "m, zoom in", "m, d", "d", "t", "repeated", "t again",
         "resize", "resize, m", "resize, m, zoom out", "resize, drag"]


@pytest.fixture(scope="module")
def font():
    from fontrx_torch.font.font import Font

    return Font.open(FONT)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def jax_frames():
    """The JAX package's session through the script (its engine resolves to
    the Pallas kernels in interpret mode on the CPU)."""
    from fontrx.engine.raster import RasterEngine
    from fontrx.font.font import Font as RefFont
    from fontrx.scene.interactive import InteractiveSession as RefSession

    sess = RefSession(RefFont.open(str(FONT)), TEXT, *SIZE, RasterEngine())
    return [(what, np.asarray(f)) for what, f in script(sess)]


@pytest.fixture(scope="module")
def port_frames(font):
    return script(InteractiveSession(font, TEXT, *SIZE, "cpu"))


class TestAgainstJax:
    @pytest.mark.parametrize("k", range(len(STEPS)), ids=STEPS)
    def test_frame(self, jax_frames, port_frames, k):
        what, want = jax_frames[k]
        got_what, got = port_frames[k]
        assert what == got_what == STEPS[k]
        assert isinstance(got, np.ndarray) and got.dtype == np.uint8
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)

    def test_the_script_covers_each_mode(self, port_frames):
        frames = dict(port_frames)
        assert set(np.unique(frames["m"])) == {0, 63, 127, 191, 255}  # MSAA
        assert 100 in np.unique(frames["d"])                          # the debug gray
        assert frames["t"].shape == (*SIZE[::-1], 4)
        assert (frames["t"][..., 3] == frames["t"][..., 0]).all()     # transparent
        assert (frames["t again"][..., 3] == 255).all()               # opaque
        assert frames["resize"].shape == RESIZED[::-1]
        assert len(np.unique(frames["resize, m, zoom out"])) > 2

    def test_layout_equals_the_incremental_engine(self, font):
        """Config 5's text, as the JAX session lays it out."""
        from fontrx.font.font import Font as RefFont
        from fontrx.scene.incremental import IncrementalLayoutEngine

        ref_font = RefFont.open(str(FONT))
        want = IncrementalLayoutEngine(
            ref_font, kern=False, ligatures=False, marks=False, features=None,
            positioning=None, rtl=False, bidi=False).layout(CONFIG5_TEXT)
        got = InteractiveSession(font, CONFIG5_TEXT, 1920, 1080, "cpu").layout
        assert got.slot_gids == list(want.slot_gids)
        assert got.slot_chars == list(want.slot_chars)
        np.testing.assert_array_equal(got.batch.segments, np.asarray(want.batch.segments))
        np.testing.assert_array_equal(got.batch.seg_counts, np.asarray(want.batch.seg_counts))
        for a, b in zip(got.instance_arrays(), want.instance_arrays()):
            np.testing.assert_array_equal(a, b)
        assert (got.width, got.height) == (want.width, want.height)


class TestSession:
    def test_unchanged_view_renders_once(self, font, monkeypatch):
        sess = InteractiveSession(font, TEXT, *SIZE, "cpu")
        calls = []
        render = sess.renderer.render_direct
        monkeypatch.setattr(sess.renderer, "render_direct",
                            lambda *a, **kw: calls.append(kw) or render(*a, **kw))
        first = sess.frame()
        again = sess.frame()
        assert len(calls) == 1 and np.array_equal(first, again)
        sess.drag(0.01, 0.0)
        sess.frame()
        assert len(calls) == 2
        sess.key("m")  # the reference re-renders MSAA and debug frames
        sess.frame()
        sess.frame()
        assert len(calls) == 4 and calls[-1] == {"msaa": True, "debug": False}

    def test_pipeline_returns_the_previous_frame(self, font):
        plain = InteractiveSession(font, TEXT, *SIZE, "cpu")
        piped = InteractiveSession(font, TEXT, *SIZE, "cpu", pipeline=True)
        want = []
        for sess, out in ((plain, want), (piped, got := [])):
            out.append(sess.frame())
            sess.scroll(-0.5, (0.1, 0.1))
            out.append(sess.frame())
            sess.key("m")
            out.append(sess.frame())
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[0])
        np.testing.assert_array_equal(got[2], want[1])

    def test_events_apply_in_order(self, font):
        """Resize, the toggles, zoom, then drag, each consumed by the frame."""
        sess = InteractiveSession(font, TEXT, *SIZE, "cpu")
        view = sess.view
        sess.resize(*RESIZED)
        sess.scroll(0.5, (0.1, 0.1))
        sess.drag(0.01, 0.02)
        sess.key("m")
        sess.frame()
        want = view.with_aspect(*RESIZED).zoomed(0.5, (0.1, 0.1)).dragged(0.01, 0.02)
        assert sess.view == want
        assert (sess.width, sess.height) == RESIZED and sess.renderer.width == RESIZED[0]
        assert sess.msaa and sess.events == EventState(cursor=(0.1, 0.1))

    def test_stats(self, font):
        sess = InteractiveSession(font, TEXT, *SIZE, "cpu")
        for _ in range(3):
            sess.frame()
        stats = sess.stats()
        assert set(stats) == {"frames", "mean_ms", "p99_ms", "fps", "compute_ms",
                              "compute_fps"}
        assert stats["frames"] == 3 and stats["mean_ms"] >= stats["compute_ms"] > 0

    @pytest.mark.parametrize("call", [
        "cycle_mode", "key c", "step_variation", "set_axis", "key [", "key ]"])
    def test_not_ported(self, font, call):
        sess = InteractiveSession(font, TEXT, *SIZE, "cpu")
        name, *arg = call.split()
        args = {"step_variation": (1,), "set_axis": ("wght", 500.0)}.get(name, tuple(arg))
        with pytest.raises(NotImplementedError, match="not ported"):
            getattr(sess, name)(*args)

    @pytest.mark.parametrize("options", [
        {"mode": "composite"}, {"mode": "color", "kern": True}, {"kern": True},
        {"ligatures": True},
        {"rtl": True}, {"layout_options": {"underline": True}}])
    def test_unported_options_raise(self, font, options):
        with pytest.raises(NotImplementedError):
            InteractiveSession(font, TEXT, *SIZE, "cpu", **options)

    def test_layout_is_layout_text(self, font):
        sess = InteractiveSession(font, TEXT, *SIZE, "cpu")
        np.testing.assert_array_equal(sess.layout.batch.segments,
                                      layout_text(font, TEXT).batch.segments)


@pytest.mark.requires_cuda
class TestOnCard:
    def test_script_equals_the_cpu_session(self, font, cuda, port_frames):
        sess = InteractiveSession(font, TEXT, *SIZE, cuda)
        for (what, want), (_, got) in zip(port_frames, script(sess)):
            np.testing.assert_array_equal(got, want, err_msg=what)

    def test_launches(self, font, cuda):
        sess = InteractiveSession(font, TEXT, *RESIZED, cuda)
        before = (page.launches, page.msaa_launches)
        sess.frame()
        sess.frame()  # unchanged view: the cached page
        assert (page.launches, page.msaa_launches) == (before[0] + 1, before[1])
        sess.key("m")
        sess.frame()
        assert (page.launches, page.msaa_launches) == (before[0] + 1, before[1] + 1)
