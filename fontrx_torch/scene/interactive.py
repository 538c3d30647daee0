"""Headless interactive session: zoom/pan/toggle events -> re-rendered frames.

A port of the direct and colour modes of ``fontrx/scene/interactive.py``
(``EventState``, ``InteractiveSession``: lines 36-147, 219-399 and
401-422), the analog of the original viewer's window loop: events
accumulate between frames, and each ``frame()`` consumes them, updates the
view and re-rasters the page through ``PageRenderer.render_direct`` (BASELINE
config 5), or with ``mode="color"`` through ``PageRenderer.render_color``
(COLR v0 layers; uint8 ``[H, W, 3]`` frames, which MSAA, debug and the
pipeline do not change). Frames come back as host arrays.

- scroll -> exponential zoom about the cursor
- drag   -> pan
- ``m``  -> toggle MSAA (the 2 x 2 page of the MSAA kernel)
- ``d``  -> toggle the debug winding gray
- ``t``  -> toggle the transparent background of ``display_frame``
- resize -> aspect-ratio update and a new renderer
- ``char_input`` / ``backspace`` -> text edits (UAX#29 grapheme clusters),
  re-laid out by the paragraph-cached ``IncrementalLayoutEngine``

The edit path is the dirty-strip cache of ``_render_direct_cached``: while
the view, the size and the toggles stay as they were, an edit re-renders
only the 256-row band over the lines it dirtied (one launch of the page
kernel with 256 rows) and splices it into a copy of the cached page; a
dirty span wholly off the page re-renders nothing.

Not ported, each raising ``NotImplementedError`` with its ROADMAP item: the
composite mode, and the ``c`` key, whose cycle passes through it (item 8),
the variable-font keys ``[`` and ``]`` with ``set_axis`` (item 18), and layout
options at other than their defaults (item 7a).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from fontrx_torch.font.font import Font
from fontrx_torch.font.uax29 import grapheme_clusters
from fontrx_torch.scene.incremental import IncrementalLayoutEngine
from fontrx_torch.scene.layout import TextLayout
from fontrx_torch.scene.page import PageRenderer
from fontrx_torch.scene.transform import ViewTransform


def drop_clusters(text: str, n: int) -> str:
    """``text`` without its last ``n`` extended grapheme clusters. Clusters
    never cross a LF (UAX#29 GB4/GB5; CR LF is one cluster, GB3), so only
    the last paragraph is segmented: a backspace costs a paragraph, not the
    text."""
    while n > 0 and text:
        head, sep, last = text.rpartition("\n")
        if not last:  # a trailing newline is a cluster of its own
            text = head[:-1] if head.endswith("\r") else head
            n -= 1
            continue
        clusters = grapheme_clusters(last)
        take = min(n, len(clusters))
        text = head + sep + "".join(clusters[:-take] if take < len(clusters) else [])
        n -= take
    return text


@dataclass
class EventState:
    """Accumulated inter-frame events."""

    scroll: float = 0.0
    cursor: tuple[float, float] = (0.0, 0.0)  # NDC
    dragging: bool = False
    drag_delta: tuple[float, float] = (0.0, 0.0)
    resized: tuple[int, int] | None = None
    toggle_msaa: bool = False
    toggle_debug: bool = False
    toggle_transparent: bool = False


@dataclass
class InteractiveSession:
    """A session over ``text`` on a ``width x height`` page on ``device``
    (``"cuda"``, ``"cpu"`` or a ``torch.device``), in ``mode`` ``"direct"``
    or ``"color"``. With ``pipeline`` a direct frame dispatches its page and
    returns the previous one (two frames in flight)."""

    font: Font
    text: str
    width: int
    height: int
    device: torch.device | str
    mode: str = "direct"
    pipeline: bool = False
    msaa: bool = False
    debug: bool = False
    transparent: bool = False
    kern: bool = False
    ligatures: bool = False
    marks: bool = False
    features: tuple[bytes, ...] | None = None
    positioning: tuple[bytes, ...] | None = None
    rtl: bool = False
    bidi: bool = False
    layout_options: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.mode not in ("direct", "color"):
            raise NotImplementedError(
                f"mode={self.mode!r}: the direct and colour modes are ported (composite: "
                "ROADMAP item 8)")
        self.device = torch.device(self.device)
        # paragraph-cached layout: an edit re-lays only the paragraphs it
        # changed, equal to a whole layout_text; layout_text raises on any
        # of these options away from its default (item 7a)
        self._layout_engine = IncrementalLayoutEngine(
            self.font, kern=self.kern, ligatures=self.ligatures, marks=self.marks,
            features=self.features, positioning=self.positioning, rtl=self.rtl,
            bidi=self.bidi, **self.layout_options)
        self.layout: TextLayout = self._layout_engine.layout(self.text)
        self.view = ViewTransform.init(self.font.info.units_per_em, self.width, self.height)
        self.events = EventState()
        self.renderer = self._renderer()
        self.frame_count = 0
        self.frame_ms: list[float] = []
        self.compute_ms: list[float] = []
        self._inflight = None    # the page dispatched by the last pipelined frame
        # the dirty-strip cache: the last direct page (on the device), the
        # view, size and toggles it was rendered under, and the line span
        # that edits have dirtied since ("all": a full render is needed)
        self._page_dev = None
        self._page_state = None
        self._pending_dirty: object = "all"
        self._dirty_margin = self._layout_margins()
        # the baseline of the dirty lines, so that the first edit has a span
        self._layout_engine.consume_dirty_lines()

    def _renderer(self) -> PageRenderer:
        return PageRenderer(self.font, self.layout, self.width, self.height, self.device)

    def _layout_margins(self) -> tuple[float, float]:
        """The layout's lowest glyph bottom and highest glyph top, in font
        units (0, 0 for no glyphs)."""
        boxes = np.asarray(self.layout.batch.boxes)
        if len(boxes) == 0:
            return (0.0, 0.0)
        return (float(boxes[:, 1].min()), float(boxes[:, 3].max()))

    # -- event feeds -------------------------------------------------------

    def scroll(self, amount: float, cursor_ndc=(0.0, 0.0)):
        self.events.scroll += amount
        self.events.cursor = cursor_ndc

    def drag(self, dx_ndc: float, dy_ndc: float):
        self.events.dragging = True
        d = self.events.drag_delta
        self.events.drag_delta = (d[0] + dx_ndc, d[1] + dy_ndc)

    def resize(self, width: int, height: int):
        self.events.resized = (width, height)

    def key(self, k: str):
        if k == "m":
            self.events.toggle_msaa = True
        elif k == "d":
            self.events.toggle_debug = True
        elif k == "t":
            self.events.toggle_transparent = True
        elif k in ("[", "]"):
            self.step_variation(-1 if k == "[" else 1)
        elif k == "c":
            self.cycle_mode()

    def step_variation(self, direction: int, axis: bytes = b"wght"):
        raise NotImplementedError("variable-font axes are not ported")

    def set_axis(self, tag: str, value: float):
        raise NotImplementedError("variable-font axes are not ported")

    def cycle_mode(self):
        raise NotImplementedError(
            "cycle_mode: its cycle passes through the composite mode, which is not ported "
            "(ROADMAP item 8)")

    def char_input(self, text: str):
        """Append typed characters and lay the text out again."""
        self._set_text(self.text + text)

    def backspace(self, n: int = 1):
        """Delete the last ``n`` extended grapheme clusters (a base and its
        marks, a Hangul syllable, an emoji ZWJ sequence or a flag pair each)
        and lay the text out again."""
        if n > 0 and self.text:
            self._set_text(drop_clusters(self.text, n))

    def _set_text(self, text: str):
        # laid out first: a character the layout does not port raises and
        # leaves the session as it was
        self.layout = self._layout_engine.layout(text)
        self.text = text
        # add the edit's dirty lines to the span the next frame re-renders;
        # the glyph-extent margins join the old and the new layout, so the
        # band also covers ink that overhung from the text before the edit
        d = self._layout_engine.consume_dirty_lines()
        if d is None:
            self._pending_dirty = "all"
        elif d != (0, 0) and self._pending_dirty != "all":
            p = self._pending_dirty
            self._pending_dirty = d if p == () else (min(p[0], d[0]), max(p[1], d[1]))
        mn, mx = self._layout_margins()
        self._dirty_margin = (min(self._dirty_margin[0], mn), max(self._dirty_margin[1], mx))
        self.renderer = self._renderer()

    # -- frame loop --------------------------------------------------------

    def frame(self) -> np.ndarray:
        """Consume the events, update the view, re-raster: the page as a
        uint8 ``[H, W]`` host array (``[H, W, 3]`` in colour mode). Events apply in the original's order:
        resize, the toggles, zoom, drag."""
        t0 = time.perf_counter()
        ev = self.events
        if ev.resized is not None:
            self.width, self.height = ev.resized
            self.view = self.view.with_aspect(self.width, self.height)
            self.renderer = self._renderer()
            ev.resized = None
        if ev.toggle_msaa:
            self.msaa = not self.msaa
            ev.toggle_msaa = False
        if ev.toggle_debug:
            self.debug = not self.debug
            ev.toggle_debug = False
        if ev.toggle_transparent:
            self.transparent = not self.transparent
            ev.toggle_transparent = False
        if ev.scroll != 0.0:
            self.view = self.view.zoomed(ev.scroll, ev.cursor)
            ev.scroll = 0.0
        if ev.drag_delta != (0.0, 0.0):
            self.view = self.view.dragged(*ev.drag_delta)
            ev.drag_delta = (0.0, 0.0)
            ev.dragging = False

        if self.mode == "color":
            # COLR/CPAL layers over white, uint8 [H, W, 3]; MSAA and debug
            # do not apply: the layers' coverage is antialiased already
            page_host = self.renderer.render_color(self.view)
            self.compute_ms.append((time.perf_counter() - t0) * 1e3)
        elif self.pipeline:
            # frames in flight: dispatch this frame, fetch the previous one
            page_dev = self.renderer.render_direct(self.view, msaa=self.msaa, debug=self.debug)
            prev, self._inflight = self._inflight, page_dev
            self.compute_ms.append((time.perf_counter() - t0) * 1e3)
            page_host = (prev if prev is not None else page_dev).cpu().numpy()
        else:
            page_dev = self._render_direct_cached(msaa=self.msaa, debug=self.debug)
            if page_dev.is_cuda:
                torch.cuda.synchronize(page_dev.device)
            self.compute_ms.append((time.perf_counter() - t0) * 1e3)
            page_host = page_dev.cpu().numpy()  # the display boundary
        self.frame_count += 1
        self.frame_ms.append((time.perf_counter() - t0) * 1e3)
        return page_host

    _BAND_H = 256  # the dirty strip's height in page rows

    def _render_direct_cached(self, msaa: bool = False, debug: bool = False) -> torch.Tensor:
        """The frame's page on the device, with the dirty-strip cache. While
        the view, the size and the toggles are unchanged and MSAA and debug
        are off: no edit returns the cached page; an edit whose dirty lines
        fit a band renders that band of 256 rows and writes it into a copy
        of the cached page (pages handed out earlier never change); an edit
        wholly off the page returns the cached page. Anything else (a view,
        size or toggle change, a dirty span taller than the band, a page
        shorter than it, MSAA, debug) renders the whole page."""
        view_state = (tuple(self.view.scale), tuple(self.view.offset), self.view.aspect_ratio,
                      self.width, self.height, msaa, debug)
        band = None
        if (self._page_dev is not None and self._page_state == view_state
                and not msaa and not debug and self._pending_dirty != "all"):
            if self._pending_dirty == ():
                return self._page_dev
            band = self._dirty_band(*self._pending_dirty)
            if band == (0, 0):  # the dirty span lies wholly off the page
                self._pending_dirty = ()
                self._dirty_margin = self._layout_margins()
                return self._page_dev
        if band is not None:
            y0, rows = band
            strip = self.renderer.render_direct(self.view, band=band)
            page_dev = self._page_dev.clone()
            page_dev[y0:y0 + rows] = strip
        else:
            page_dev = self.renderer.render_direct(self.view, msaa=msaa, debug=debug)
        self._page_dev = page_dev
        self._page_state = view_state
        self._pending_dirty = ()
        self._dirty_margin = self._layout_margins()
        return page_dev

    def _dirty_band(self, l0: int, l1: int):
        """The page rows ``(y0, 256)`` over the dirty visual lines ``[l0,
        l1)``, with ``y0`` clamped to ``[0, height - 256]``; ``(0, 0)`` when
        they lie wholly off the page; ``None`` when they are taller than the
        band or the page is shorter than it (a full render)."""
        lh = float(self._layout_engine._line_height())
        mn, mx = self._dirty_margin
        s1 = self.view.scale[1]
        o1 = self.view.offset[1]
        ar = self.view.aspect_ratio

        def py(em_y: float) -> float:
            return (1.0 - (em_y * s1 + o1) * ar) / 2.0 * self.height

        y_top = int(np.floor(py(-l0 * lh + mx))) - 1
        y_bot = int(np.ceil(py(-(l1 - 1) * lh + mn))) + 1
        if y_bot <= 0 or y_top >= self.height:
            return (0, 0)
        bh = self._BAND_H
        if y_bot - y_top > bh or self.height < bh:
            return None
        return (max(0, min(y_top, self.height - bh)), bh)

    def display_frame(self) -> np.ndarray:
        """One frame as displayable RGBA (uint8 ``[H, W, 4]``): a colour frame
        opaque; a direct one with the ``t`` toggle over a transparent
        background (alpha = coverage), else opaque over black."""
        return PageRenderer.to_rgba(self.frame(), self.transparent)

    def stats(self) -> dict:
        """Frame times in ms, the first (set-up) frame dropped: whole frames
        (the page to the host included) and the render alone."""
        ms = self.frame_ms[1:] or self.frame_ms
        cms = self.compute_ms[1:] or self.compute_ms
        return {
            "frames": self.frame_count,
            "mean_ms": float(np.mean(ms)) if ms else 0.0,
            "p99_ms": float(np.percentile(ms, 99)) if ms else 0.0,
            "fps": 1000.0 / float(np.mean(ms)) if ms else 0.0,
            "compute_ms": float(np.mean(cms)) if cms else 0.0,
            "compute_fps": 1000.0 / float(np.mean(cms)) if cms else 0.0,
        }
