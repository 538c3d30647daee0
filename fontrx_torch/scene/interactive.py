"""Headless interactive session: zoom/pan/toggle events -> re-rendered frames.

A port of the direct mode of ``fontrx/scene/interactive.py``
(``EventState``, ``InteractiveSession``: lines 36-117, 127-147, 275-378 and
401-422), the analog of the original viewer's window loop: events
accumulate between frames, and each ``frame()`` consumes them, updates the
view and re-rasters the page through ``PageRenderer.render_direct`` (BASELINE
config 5). Frames come back as host arrays.

- scroll -> exponential zoom about the cursor
- drag   -> pan
- ``m``  -> toggle MSAA (the 2 x 2 page of the MSAA kernel)
- ``d``  -> toggle the debug winding gray
- ``t``  -> toggle the transparent background of ``display_frame``
- resize -> aspect-ratio update and a new renderer

Not ported, each raising ``NotImplementedError`` with its ROADMAP item: the
composite and colour modes and the ``c`` key (items 8 and 13), the text
edits ``char_input`` and ``backspace`` with their dirty-strip splice (item
9), the variable-font keys ``[`` and ``]``, and layout options at other than
their defaults (item 7a). So the view-state cache of
``_render_direct_cached`` has no band splice.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from fontrx_torch.font.font import Font
from fontrx_torch.scene.layout import layout_text
from fontrx_torch.scene.page import PageRenderer
from fontrx_torch.scene.transform import ViewTransform


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
    """A direct-mode session over ``text`` on a ``width x height`` page on
    ``device`` (``"cuda"``, ``"cpu"`` or a ``torch.device``). With
    ``pipeline`` a frame dispatches its page and returns the previous one
    (two frames in flight)."""

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
        if self.mode != "direct":
            raise NotImplementedError(
                f"mode={self.mode!r}: only the direct mode is ported (composite and colour: "
                "ROADMAP items 8 and 13)")
        self.device = torch.device(self.device)
        # layout_text raises on any of these away from its default (item 7a)
        self.layout = layout_text(
            self.font, self.text, kern=self.kern, ligatures=self.ligatures, marks=self.marks,
            features=self.features, positioning=self.positioning, rtl=self.rtl,
            bidi=self.bidi, **self.layout_options)
        self.view = ViewTransform.init(self.font.info.units_per_em, self.width, self.height)
        self.events = EventState()
        self.renderer = self._renderer()
        self.frame_count = 0
        self.frame_ms: list[float] = []
        self.compute_ms: list[float] = []
        self._page_dev = None    # the last direct page, on the device
        self._page_state = None  # the view, size and toggles it was rendered under
        self._inflight = None    # the page dispatched by the last pipelined frame

    def _renderer(self) -> PageRenderer:
        return PageRenderer(self.font, self.layout, self.width, self.height, self.device)

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
            "cycle_mode: the composite and colour modes are not ported (ROADMAP items 8 and 13)")

    def char_input(self, text: str):
        raise NotImplementedError("text edits are not ported (ROADMAP item 9)")

    def backspace(self, n: int = 1):
        raise NotImplementedError("text edits are not ported (ROADMAP item 9)")

    def _set_text(self, text: str):
        raise NotImplementedError("text edits are not ported (ROADMAP item 9)")

    # -- frame loop --------------------------------------------------------

    def frame(self) -> np.ndarray:
        """Consume the events, update the view, re-raster: the page as a
        uint8 ``[H, W]`` host array. Events apply in the original's order:
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

        if self.pipeline:
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

    def _render_direct_cached(self, msaa: bool = False, debug: bool = False) -> torch.Tensor:
        """The frame's page on the device. The fill of an unchanged view and
        size is the cached page, with no launch; any other frame renders."""
        view_state = (tuple(self.view.scale), tuple(self.view.offset), self.view.aspect_ratio,
                      self.width, self.height, msaa, debug)
        if (self._page_dev is not None and self._page_state == view_state
                and not msaa and not debug):
            return self._page_dev
        self._page_dev = self.renderer.render_direct(self.view, msaa=msaa, debug=debug)
        self._page_state = view_state
        return self._page_dev

    def display_frame(self) -> np.ndarray:
        """One frame as displayable RGBA (uint8 ``[H, W, 4]``): with the
        ``t`` toggle the background is transparent (alpha = coverage), else
        opaque over black."""
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
