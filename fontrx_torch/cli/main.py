"""The command line: ``python -m fontrx_torch``.

The port of ``fontrx/cli/main.py``: parse the flags, open the font, lay the
text out, render, and write the image as QOI (``-o``) or print it as ASCII;
or, with ``-i``, run the interactive session on events read from stdin. The
modes and the kernels they launch:

- ``fill``, ``gray``: the page kernel (K7, ``page()``), once (BASELINE
  config 1); gray maps ink to 255 and the rest to 100;
- ``coverage``: the k x k coverage kernel, once (config 2);
- ``sdf``, ``smooth``, ``outline``: the SDF (``winding()`` for the sign,
  then ``sdf.cu``);
- ``triangulation``: the Loop-Blinn kernel, once, or ``winding()`` for an
  outline that crosses itself; ``-d`` draws the triangle classes on the host
  and launches nothing;
- ``color``: COLR v0 colour glyphs (``engine.colorglyphs``): the coverage
  kernel once over every (glyph, layer) row, the layers folded src-over into
  premultiplied RGBA tiles, the tiles composited at the pen positions;
  ``--palette`` picks the CPAL palette (an index, ``light`` or ``dark``);
- ``-i``: ``InteractiveSession`` (``page()``, and ``page_msaa()`` after the
  ``m`` key).

``--backend`` picks the device: ``auto`` and ``cuda`` the first CUDA device
(raising where there is none), ``cpu`` the kernels' plain versions. Images
come to the host once, at the end of each mode.

Not ported, each raising ``NotImplementedError`` with its ROADMAP item: the
``lcd`` mode (10b), COLR v1, OT-SVG and bitmap colour glyphs in the
``color`` mode (13b), ``--hinting`` and ``--bitmaps`` in
the fill and gray modes (14), ``--info`` (14), ``--serve`` (14),
``--fallback`` (``FontStack``, 14), ``--variation`` (18), and every layout
flag away from its default (7a; in every mode, ``-i`` included).
"""

from __future__ import annotations

import dataclasses
import logging
import sys

import numpy as np
import torch

from fontrx_torch.cli.config import BACKENDS, Config, ConfigError, HelpRequested, parse_args
from fontrx_torch.convert import grid_anchors
from fontrx_torch.device import require_cuda
from fontrx_torch.engine.colorglyphs import color_glyph_tiles, composite_color_page
from fontrx_torch.engine.raster import RasterEngine
from fontrx_torch.font.font import Font
from fontrx_torch.geometry import TriangulatedGlyph
from fontrx_torch.io.qoi import encode_rgb, encode_rgba
from fontrx_torch.kernels.grid import RasterGrid
from fontrx_torch.kernels.loopblinn import debug_render, loopblinn_fill
from fontrx_torch.kernels.sdf import sdf_to_u8
from fontrx_torch.pack.segments import glyph_segments
from fontrx_torch.scene.interactive import InteractiveSession
from fontrx_torch.scene.layout import layout_text
from fontrx_torch.scene.page import PageRenderer
from fontrx_torch.scene.transform import ViewTransform

log = logging.getLogger("fontrx_torch.Main")


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    try:
        cfg = parse_args(argv)
    except HelpRequested as e:
        print(e)
        return 0
    except ConfigError as e:
        for err in e.errors:
            print(f"error: {err}", file=sys.stderr)
        return 2

    check_options(cfg)
    if cfg.info:
        raise NotImplementedError("--info: font_info_text is not ported (ROADMAP item 14)")
    if cfg.serve:
        raise NotImplementedError(
            "--serve: the browser viewer (cli/serve.py) is not ported (ROADMAP item 14)")
    # -c needs nothing: the kernels are built once into build/

    font = Font.open(cfg.font_file)
    engine = engine_for(cfg.backend)
    text = cfg.text if cfg.text is not None else "A"

    if cfg.interactive:
        return _run_interactive(font, text, cfg, engine)

    out_img = _render(font, text, cfg, engine)
    if cfg.output:
        with open(cfg.output, "wb") as f:
            f.write(encode_rgb(out_img))
        log.info("wrote %s", cfg.output)
    else:
        _print_ascii(out_img)
    return 0


def engine_for(backend: str) -> RasterEngine:
    """The engine of a ``--backend`` value: the first CUDA device for
    ``auto`` and ``cuda`` (raising ``RuntimeError`` where there is none),
    the CPU for ``cpu``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: the backends are " + "|".join(BACKENDS))
    return RasterEngine(torch.device("cpu") if backend == "cpu" else require_cuda())


# the layout flags: the port's layout_text takes each at its default only
# (ROADMAP item 7a)
LAYOUT_FLAGS = ("kern", "ligatures", "marks", "features", "vertical", "positioning", "wrap",
                "oblique", "rtl", "bidi", "alternate", "letter_spacing", "word_spacing",
                "underline", "strikethrough", "tracking", "align", "kashida")


def check_options(cfg) -> None:
    """Raise ``NotImplementedError`` for the font and layout options that are
    not ported, before anything is opened or rendered."""
    if cfg.fallback:
        raise NotImplementedError(
            "--fallback: FontStack is not ported (ROADMAP item 14, FontStack)")
    if cfg.variation:
        raise NotImplementedError("--variation: variable fonts are not ported (ROADMAP item 18)")
    default = {f.name: f.default for f in dataclasses.fields(Config)}
    for name in LAYOUT_FLAGS:
        if getattr(cfg, name) != default[name]:
            raise NotImplementedError(
                f"--{name} {getattr(cfg, name)!r}: layout options are not ported "
                "(ROADMAP item 7a)")


def _tiles(layout, font, cfg) -> list[RasterGrid]:
    """Fixed ``size x size`` tiles, one per glyph slot of the layout."""
    return [
        RasterGrid.fixed_tile(tuple(b), cfg.size, font.info.units_per_em, cfg.size)
        for b in np.asarray(layout.batch.boxes)
    ]


def _sdf_for_layout(layout, font, cfg, engine, spread_px: float) -> torch.Tensor:
    """The sdf, smooth and outline modes' distance field: one tile per glyph
    slot, clamped at ``+-spread_px`` (the original's Pallas route; one
    kernel serves every tile size, so there is no flat or tiled route and no
    pack)."""
    return engine.sdf_batch(
        layout.batch.segments, *grid_anchors(_tiles(layout, font, cfg)),
        height=cfg.size, width=cfg.size, spread_px=spread_px,
    )


def page_view(font, layout, size: int) -> tuple[int, int, ViewTransform]:
    """The fill and gray modes' page: ``(width, height, view)``, 1 em ==
    ``size`` px, a margin of ``max(size // 8, 4)`` px, the text's origin at
    the left margin and its last line's descent on the bottom margin."""
    upem = font.info.units_per_em
    px_per_unit = size / upem
    margin = max(size // 8, 4)
    width = int(layout.width * px_per_unit) + 2 * margin
    height = int(layout.height * px_per_unit) + 2 * margin
    s = 2.0 * px_per_unit / width
    sy = 2.0 * px_per_unit / height
    ox = -1.0 + 2.0 * margin / width
    descent_px = -font.info.descent * px_per_unit
    oy = -1.0 + 2.0 * (margin + descent_px
                       + layout.height * px_per_unit
                       - (font.info.ascent + font.info.line_gap
                          - font.info.descent) * px_per_unit) / height
    # ViewTransform.apply multiplies y by aspect; pre-divide so the
    # net y scale is sy
    view = ViewTransform(
        (s, sy * height / width), (ox, oy * height / width),
        width / height,
    )
    return width, height, view


def _rgb(gray) -> np.ndarray:
    """A uint8 ``[H, W]`` image (a tensor or an array) on the host as RGB
    ``[H, W, 3]``, gray in each channel."""
    if torch.is_tensor(gray):
        gray = gray.cpu().numpy()
    return np.repeat(gray[:, :, None], 3, axis=2)


def _sheet(tiles: torch.Tensor) -> np.ndarray:
    """uint8 ``[B, H, W]`` tiles side by side, as RGB ``[H, B * W, 3]`` on
    the host."""
    b, h, w = tiles.shape
    return _rgb(tiles.permute(1, 0, 2).reshape(h, b * w))


def _render(font, text, cfg, engine) -> np.ndarray:
    if cfg.hinting or cfg.bitmaps:
        if cfg.mode in ("fill", "gray"):
            raise NotImplementedError(
                "--hinting/--bitmaps: the hinted fill is not ported (ROADMAP item 14)")
        log.warning(
            "--hinting/--bitmaps apply to the fill/gray modes only; "
            "rendering %r unhinted", cfg.mode,
        )

    if cfg.mode in ("fill", "gray"):
        layout = layout_text(font, text)
        width, height, view = page_view(font, layout, cfg.size)
        page = PageRenderer(font, layout, width, height, engine.device).render_direct(view)
        if cfg.mode == "gray":
            page = torch.where(page > 0, 255, 100).to(torch.uint8)
        return _rgb(page)

    if cfg.mode == "color":
        return _render_color(font, text, cfg, engine)

    if cfg.mode == "coverage":
        layout = layout_text(font, text)
        cov = engine.coverage_batch(
            layout.batch.segments, *grid_anchors(_tiles(layout, font, cfg)),
            height=cfg.size, width=cfg.size, samples=max(cfg.samples, 2),
        )
        return _sheet(engine.coverage_to_gray(cov))

    if cfg.mode == "smooth":
        # antialiased fill from the distance field: coverage =
        # clamp(d + 0.5 + embolden, 0, 1) — one-pixel soft edges
        # without MSAA, and --embolden E dilates (E>0) or thins (E<0)
        # the outline by E pixels (synthetic bold/light)
        layout = layout_text(font, text)
        sdf = _sdf_for_layout(layout, font, cfg, engine, abs(cfg.embolden) + 2.0)
        cov = torch.clamp(sdf + 0.5 + cfg.embolden, 0.0, 1.0)
        return _sheet(torch.round(cov * 255).to(torch.uint8))

    if cfg.mode == "lcd":
        raise NotImplementedError(
            "-m lcd: LCD subpixel coverage is not ported (ROADMAP item 10b)")

    if cfg.mode == "outline":
        # stroked outlines from the distance field: coverage =
        # clamp(stroke/2 + 0.5 - |d|, 0, 1) — one-pixel antialiased
        # edges on both sides, any stroke width
        layout = layout_text(font, text)
        half = max(cfg.stroke / 2.0, 0.5)
        sdf = _sdf_for_layout(layout, font, cfg, engine, half + 1.0)
        cov = torch.clamp(half + 0.5 - sdf.abs(), 0.0, 1.0)
        return _sheet(torch.round(cov * 255).to(torch.uint8))

    if cfg.mode == "sdf":
        layout = layout_text(font, text)
        return _sheet(sdf_to_u8(_sdf_for_layout(layout, font, cfg, engine, 8.0)))

    if cfg.mode == "triangulation":
        ch = text[0]
        glyph, _ = font.get_glyph(ch)
        grid = RasterGrid.for_glyph_box(
            (glyph.box.x_min, glyph.box.y_min, glyph.box.x_max, glyph.box.y_max),
            cfg.size,
            font.info.units_per_em,
        )
        tg = TriangulatedGlyph.from_glyph(glyph)
        if cfg.debug:
            return debug_render(tg, grid)
        if tg.self_intersecting:
            # the triangle mesh would fill the wrong region; the winding
            # fill handles crossing contours by the nonzero rule
            log.warning(
                "%r outline self-intersects: triangulation mode falling "
                "back to the winding fill", ch,
            )
            return _rgb(engine.fill(engine.winding_glyph(glyph_segments(glyph), grid)))
        return _rgb(loopblinn_fill(tg, grid, device=engine.device))

    raise SystemExit(f"unknown mode {cfg.mode!r}")


def color_palette(font, selector) -> int:
    """The CPAL palette that ``--palette`` picks: an index, or ``light`` or
    ``dark`` (the first palette flagged for that background); an unknown
    selector or an index out of range warns and takes palette 0, as does a
    font without CPAL."""
    if font.cpal is None:
        return 0
    try:
        palette = (int(selector) if str(selector).lstrip("-").isdigit()
                   else font.cpal.select(selector))
    except ValueError:
        log.warning("unknown palette selector %r; using 0", selector)
        return 0
    if not 0 <= palette < font.cpal.num_palettes:
        log.warning("palette %d out of range (%d palettes); using 0", palette,
                    font.cpal.num_palettes)
        return 0
    return palette


def _render_color(font, text, cfg, engine) -> np.ndarray:
    """The ``color`` mode: COLR v0 layers of every glyph of the layout (a
    glyph without layers as one black layer of its outline), composited over
    white; 1 em == ``size`` px, a margin of ``max(size // 8, 4)`` px, the
    first baseline an ascent below the top margin."""
    layout = layout_text(font, text)
    if (font.colr is None or font.cpal is None) and not any(
            tag in font.tables for tag in (b"sbix", b"CBDT", b"SVG ")):
        log.warning("font has no COLR/CPAL, SVG documents, or bitmap strikes; color mode "
                    "renders the monochrome outlines")
    palette = color_palette(font, cfg.palette)
    tiles, grids = color_glyph_tiles(font, [int(g) for g in layout.slot_gids], cfg.size, engine,
                                     palette=palette, samples=max(cfg.samples, 2))
    ppu = cfg.size / font.info.units_per_em
    margin = max(cfg.size // 8, 4)
    width = int(layout.width * ppu) + 2 * margin
    height = int(layout.height * ppu) + 2 * margin
    slots, offsets_em = layout.instance_arrays()
    pen = np.empty((len(slots), 2), np.float64)
    pen[:, 0] = margin + offsets_em[:, 0] * ppu
    # em y up -> page y down
    pen[:, 1] = margin + font.info.ascent * ppu - offsets_em[:, 1] * ppu
    return composite_color_page(tiles, grids, slots, pen, page_h=height, page_w=width)


def _run_interactive(font, text, cfg, engine) -> int:
    """Headless interactive loop: reads events from stdin, one per line:
    ``scroll <amt> [cx cy]`` / ``drag <dx> <dy>`` / ``resize <w> <h>`` /
    ``key <m|d|t>`` / ``type <text>`` / ``back [n]`` / ``frame`` /
    ``stats`` / ``quit``.  Writes frames
    to ``--output`` (numbered) when given."""
    sess = InteractiveSession(font, text, 1920, 1080, engine.device)
    n = 0
    for line in sys.stdin:
        parts = line.split()
        if not parts:
            continue
        cmd, *args = parts
        try:
            n = _dispatch(sess, cfg, cmd, args, n)
        except StopIteration:
            break
        except (ValueError, IndexError) as e:
            print(f"error: bad command {line.strip()!r} ({e})", file=sys.stderr)
    print(sess.stats(), flush=True)
    return 0


def _dispatch(sess, cfg, cmd, args, n) -> int:
    if cmd == "quit":
        raise StopIteration
    elif cmd == "scroll":
        cur = (float(args[1]), float(args[2])) if len(args) >= 3 else (0.0, 0.0)
        sess.scroll(float(args[0]), cur)
    elif cmd == "drag":
        sess.drag(float(args[0]), float(args[1]))
    elif cmd == "resize":
        sess.resize(int(args[0]), int(args[1]))
    elif cmd == "key":
        sess.key(args[0])
    elif cmd == "type":
        sess.char_input(" ".join(args))
    elif cmd == "back":
        sess.backspace(int(args[0]) if args else 1)
    elif cmd == "frame":
        # display_frame routes through to_rgba so the 't' (transparent
        # background) toggle is observable in the emitted file: RGBA
        # with alpha=coverage when on, opaque RGB otherwise
        rgba = sess.display_frame()
        if cfg.output:
            path = cfg.output.replace(".qoi", f"_{n:04d}.qoi")
            with open(path, "wb") as f:
                f.write(
                    encode_rgba(rgba) if sess.transparent
                    else encode_rgb(rgba[:, :, :3])
                )
        n += 1
    elif cmd == "stats":
        print(sess.stats(), flush=True)
    else:
        raise ValueError(f"unknown command {cmd!r}")
    return n


def _print_ascii(img: np.ndarray, max_w: int = 100) -> None:
    g = img[:, :, 0]
    step = max(1, g.shape[1] // max_w)
    for row in g[:: 2 * step]:
        print("".join("#" if v > 64 else "." for v in row[::step]))


if __name__ == "__main__":
    raise SystemExit(main())
