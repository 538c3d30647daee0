"""A colour frame's time, split by stage: the tile pass (the coverage
kernel, K9, and the src-over fold of the layers) and the page composite
(``engine/colorglyphs.py``).

On a machine with a CUDA card and the CUDA toolkit:

    python -m fontrx_torch.bench.color_split

Three views of two 1920 x 1080 sessions in ``mode="color"``:

- BASELINE config 5's text and font (``benchmarks/configs.py:276-295``) at
  the session's first view (38 tiles of 1024 px, a few instances on the
  page) and zoomed out by 22 steps about the top-left corner (tiles of 128
  px, all 1,080 instances on the page);
- 20 rows of ``tests/data/colrtest.ttf``'s colour glyphs (two layers each)
  zoomed out by 24 steps, all 1,080 instances on the page.

For each it prints the median host ms, up to a synchronised card, of the
tile pass, of the coverage kernel alone (CUDA-graph replays), of the ink
boxes, of the composite and of its three stages (the origins on the host,
``rank_fold`` on the card, the background fold and the copy to the host),
and of a whole ``render_color`` frame with the tiles cached; then, under
``torch.profiler``, the device operations of ``CALLS`` composites with
their mean device time a composite, and the device's busy share of the
composite's wall time. The first line names the card and its power limit;
the last is the JSON record.
"""

from __future__ import annotations

import json
import pathlib
import time

import torch

from fontrx_torch.bench.timing import card, graph_ms, synced_ms
from fontrx_torch.engine import colorglyphs
from fontrx_torch.engine.raster import RasterEngine
from fontrx_torch.font.font import Font
from fontrx_torch.kernels import _build, coverage
from fontrx_torch.scene.interactive import InteractiveSession

CALLS = 20
ROOT = pathlib.Path(__file__).resolve().parents[2]
DEJAVU = ROOT / "fontrx_torch" / "data" / "DejaVuSans.ttf"
COLRTEST = ROOT / "tests" / "data" / "colrtest.ttf"
SIZE = (1920, 1080)
CONFIG5_TEXT = "\n".join(
    "The quick brown fox jumps over the lazy dog 0123456789" for _ in range(20))
ROWS_TEXT = "\n".join("ABCCABBCA" * 6 for _ in range(20))
# (name, font, text, zoom before the frame or None)
CASES = (
    ("config5_first", DEJAVU, CONFIG5_TEXT, None),
    ("config5_zoomed_out", DEJAVU, CONFIG5_TEXT, (-22.0, (-1.0, 1.0))),
    ("colr_rows_zoomed_out", COLRTEST, ROWS_TEXT, (-24.0, (-1.0, 1.0))),
)


def split(font_path, text, zoom, dev) -> dict:
    sess = InteractiveSession(Font.open(font_path), text, *SIZE, dev, mode="color")
    if zoom is not None:
        sess.scroll(*zoom)
    sess.frame()
    renderer, view = sess.renderer, sess.view
    h, w = renderer.height, renderer.width
    tiles, grids, ink = renderer.color_tiles(view)
    slots, pen = renderer.color_pen(view)
    x0, y0 = colorglyphs.tile_origins(grids, slots, pen, tiles.shape[1], h, w)
    rgba = colorglyphs.rank_fold(tiles, slots, x0, y0, h, w, ink)
    gids = [int(g) for g in renderer.layout.slot_gids]
    size = view.scale[0] * (w / 2.0) * renderer.font.info.units_per_em
    engine = RasterEngine(dev)
    captured = {}
    coverage_batch = coverage.coverage_batch

    def capture(*args, **kwargs):
        captured.update(args=args, kwargs=kwargs)
        return coverage_batch(*args, **kwargs)

    coverage.coverage_batch = capture
    try:
        colorglyphs.color_glyph_tiles(renderer.font, gids, size, engine, tile=tiles.shape[1])
    finally:
        coverage.coverage_batch = coverage_batch

    def composite():
        colorglyphs.composite_color_page(tiles, grids, slots, pen, page_h=h, page_w=w, ink=ink)

    rec = dict(
        tile=int(tiles.shape[1]), tiles=len(gids), instances=len(slots),
        tile_pass_ms=synced_ms(lambda: colorglyphs.color_glyph_tiles(
            renderer.font, gids, size, engine, tile=tiles.shape[1])),
        kernel_ms=graph_ms(lambda: coverage.coverage_batch(*captured["args"],
                                                           **captured["kwargs"])),
        ink_boxes_ms=synced_ms(lambda: colorglyphs.ink_boxes(tiles)),
        composite_ms=synced_ms(composite),
        origins_ms=synced_ms(lambda: colorglyphs.tile_origins(grids, slots, pen,
                                                              tiles.shape[1], h, w)),
        rank_fold_ms=synced_ms(lambda: colorglyphs.rank_fold(tiles, slots, x0, y0, h, w, ink)),
        background_and_copy_ms=synced_ms(lambda: colorglyphs._over_background(
            rgba, (255, 255, 255))),
        frame_ms=synced_ms(lambda: renderer.render_color(view)),
    )
    composite()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(CALLS):
            composite()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / CALLS
    # the device's own events (kernels, copies, memsets); the host operators
    # that launched them carry the same time again
    ops = {e.key: e.self_device_time_total / 1e3 / CALLS for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}
    rec["device_ops_ms"] = dict(sorted(ops.items(), key=lambda kv: -kv[1]))
    rec["device_busy_share"] = sum(ops.values()) / wall_ms
    rec["profiled_composite_ms"] = wall_ms
    return rec


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("color_split needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(card())
    _build.load("coverage")
    record = {}
    for name, font_path, text, zoom in CASES:
        rec = split(font_path, text, zoom, dev)
        record[name] = rec
        top = ", ".join(f"{k[:60]} {v:.4f}" for k, v in list(rec["device_ops_ms"].items())[:8])
        print(f"{name}: {rec['tiles']} tiles of {rec['tile']} px, {rec['instances']} instances; "
              f"tile pass {rec['tile_pass_ms']:.3f} ms (coverage kernel {rec['kernel_ms']:.4f}, "
              f"ink boxes {rec['ink_boxes_ms']:.3f}); composite {rec['composite_ms']:.3f} ms = "
              f"origins {rec['origins_ms']:.3f} + rank_fold {rec['rank_fold_ms']:.3f} + "
              f"background and copy {rec['background_and_copy_ms']:.3f}; frame "
              f"{rec['frame_ms']:.3f} ms; device busy {rec['device_busy_share']:.1%} of a "
              f"composite; device ms a composite: {top}")
    print(json.dumps(record))


if __name__ == "__main__":
    main()
