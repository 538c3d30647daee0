"""A page frame's device time, split by device operation: ``page()`` (K7)
and ``page_msaa()`` (K8).

On a machine with a CUDA card and the CUDA toolkit:

    python -m fontrx_torch.bench.page_split

It calls ``page.direct_page`` (K7's kernel, ``csrc/page.cu``) ``CALLS``
times under ``torch.profiler`` (CUDA activities) on three frames, the fill
that the session asks for:

- BASELINE config 5's first view (``benchmarks/configs.py:276-295``): twenty
  lines on 1920 x 1080, laid out by ``InteractiveSession``;
- the 256-row band of that frame at rows [400, 656), as the edit path
  renders a band;
- the 4K stress page's first frame (``benchmarks/stress.py:93-124``): the
  10k-character text on 3840 x 2160, zoomed out by 8 steps;

and ``page.direct_page_msaa`` (K8's kernel) on three MSAA frames, as the
session renders them with ``m`` pressed:

- config 5's first view;
- the narrow page's first view: six lines on 640 x 480, below the wide route;
- the 4K stress page's first frame.

For each it prints every device operation the frame runs (the bucket
memset and each kernel) with its mean time a frame, their sum, and beside
them the frame's time from CUDA events around the same calls and around
CUDA-graph replays (``bench.timing``). The last line is the JSON record;
the first names the card and its power limit.
"""

from __future__ import annotations

import json
import pathlib

import torch

from fontrx_torch.bench.timing import card, cuda_ms, graph_ms
from fontrx_torch.font.font import Font
from fontrx_torch.kernels import _build, page
from fontrx_torch.scene.interactive import InteractiveSession
from fontrx_torch.scene.layout import layout_text
from fontrx_torch.scene.page import PageRenderer
from fontrx_torch.scene.transform import ViewTransform

CALLS = 50
DEJAVU = pathlib.Path(__file__).resolve().parents[1] / "data" / "DejaVuSans.ttf"
CONFIG5_TEXT = "\n".join(
    "The quick brown fox jumps over the lazy dog 0123456789" for _ in range(20))
CONFIG5_SIZE = (1920, 1080)
BAND = (400, 256)
STRESS_LINE = "The quick brown fox jumps over the lazy dog. 0123456789 "
STRESS_TEXT = "\n".join(STRESS_LINE for _ in range(10000 // len(STRESS_LINE)))
STRESS_SIZE = (3840, 2160)
NARROW_TEXT = "\n".join(
    "The quick brown fox jumps over the lazy dog 0123456789" for _ in range(6))
NARROW_SIZE = (640, 480)


def frames(dev):
    """``(name, msaa, inputs, page_h, page_w, band_y0, out_h)`` of the six
    frames."""
    font = Font.open(DEJAVU)
    sess = InteractiveSession(font, CONFIG5_TEXT, *CONFIG5_SIZE, dev)
    inputs5 = sess.renderer.page_inputs(sess.view)
    narrow = InteractiveSession(font, NARROW_TEXT, *NARROW_SIZE, dev)
    w5, h5 = CONFIG5_SIZE
    wn, hn = NARROW_SIZE
    w4, h4 = STRESS_SIZE
    view4 = ViewTransform.init(font.info.units_per_em, w4, h4).zoomed(-8.0, (0.0, 0.0))
    renderer4 = PageRenderer(font, layout_text(font, STRESS_TEXT), w4, h4, dev)
    inputs4 = renderer4.page_inputs(view4)
    return [("config5", False, inputs5, h5, w5, 0, h5),
            ("config5_band", False, inputs5, h5, w5, BAND[0], BAND[1]),
            ("page4k", False, inputs4, h4, w4, 0, h4),
            ("config5_msaa", True, inputs5, h5, w5, 0, h5),
            ("narrow_msaa", True, narrow.renderer.page_inputs(narrow.view), hn, wn, 0, hn),
            ("page4k_msaa", True, inputs4, h4, w4, 0, h4)]


def split(fn) -> dict:
    """Mean device time a call of each device operation ``fn`` runs, in ms,
    from ``torch.profiler`` over ``CALLS`` calls."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    ops = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            ops[e.key] = dict(ms=us / 1e3 / CALLS, count=e.count / CALLS)
    return ops


def main() -> None:
    dev = torch.device("cuda")
    print("card:", card())
    _build.load("page")
    record = {}
    for name, msaa, inputs, h, w, y0, rows in frames(dev):
        def fn(inputs=inputs, h=h, w=w, y0=y0, rows=rows, msaa=msaa):
            if msaa:
                return page.direct_page_msaa(*inputs, page_h=h, page_w=w)
            return page.direct_page(*inputs, y0, page_h=h, page_w=w, out_h=rows)

        ops = split(fn)
        rec = dict(kernel="page_msaa" if msaa else "page", ops=ops,
                   sum_ms=sum(o["ms"] for o in ops.values()),
                   events_ms=cuda_ms(fn, inner=CALLS), graph_ms=graph_ms(fn),
                   segments=len(inputs[0]), rows=rows, width=w)
        record[name] = rec
        print(f"{name} ({rec['kernel']}, {rows} x {w}, {rec['segments']} segments): profiler "
              f"sum {rec['sum_ms']:.4f} ms a frame, CUDA events {rec['events_ms']:.4f} ms, "
              f"graph replays {rec['graph_ms']:.4f} ms")
        for key, o in sorted(ops.items(), key=lambda kv: -kv[1]["ms"]):
            print(f"  {o['ms']:.4f} ms  x{o['count']:g}  {key[:110]}")
    print(json.dumps({"card": card(), "calls": CALLS, "frames": record}))


if __name__ == "__main__":
    main()
