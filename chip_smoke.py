"""Drive fontrx_torch's glyph fill, window-packed atlas, tile coverage, SDF
atlas, Loop-Blinn atlas, direct page, interactive MSAA and sharded paths, its
roofline probe, its row-banded strip atlas, the interactive session's edit
path, the command line and the COLR v0 colour path once on one CUDA card,
and check them.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the CUDA kernels from ``fontrx_torch/csrc`` into ``build/`` (one
``nvcc`` per source, all started together), packs two atlases with the
port's own front end, then drives the paths through the entry points a user
calls, each with the kernels' launch counts set to 0 just before it and read
just after:

- **winding fill**:
  1. the 94 printable ASCII glyphs of DejaVu Sans at 256 px on 256 x 256
     tiles, through ``RasterEngine.winding_batch``;
  2. the 1024 glyphs of ``tests/data/cjktest.ttf`` (200-330 segments each)
     at 64 px on 64 x 64 tiles;
  3. the README quick start on 'A' at 256 px: ``winding_glyph`` -> ``fill``
     -> QOI encode -> decode;
  4. ``fontrx_torch.entry.entry()``'s raster step on its example batch;
- **window-packed atlas** (K3): ``RasterEngine.pack_windows`` then
  ``winding_batch(windows=...)`` on cjk64's batch at 64 and at 32 px and on
  the reference's CJK benchmark batch (``benchmarks/cjk.py:112-160``: 1000
  glyphs x 288 segments, seed 7, x-sorted per glyph) at 64 and at 32 px:
  four launches of ``winding_windows()``, none of ``winding()``;
- **tile coverage**: 2 x 2 supersampled coverage of both atlases through
  ``RasterEngine.coverage_batch``, then ``coverage_to_gray``;
- **SDF atlas** (BASELINE config 4): signed distance fields (8 px spread)
  of ascii256, cjk64 and cjk32 (the CJK batch on 32 x 32 grids) through
  ``RasterEngine.sdf_batch`` (the winding kernel for the sign, then the
  distance kernel), then ``sdf_to_u8``; the (segment, pixel) pairs the kernel
  runs its program on (``bound.sdf_kept_pairs`` at its cull box) are counted
  beside the pairs the function needs;
- **Loop-Blinn atlas** (BASELINE config 3): the 94 printable ASCII glyphs of
  DejaVu Sans triangulated by ``fontrx_torch.geometry``, padded to one
  triangle count, at 128 px on 128 x 128 tiles through
  ``loopblinn.loopblinn_batch``, and 'g' at 128 px through
  ``loopblinn.loopblinn_fill``;
- **direct page** (BASELINE config 5): twenty lines of text on a 1920 x 1080
  page through ``fontrx_torch.scene.interactive.InteractiveSession`` exactly
  as ``benchmarks/configs.py:276-295`` drives it: ``frame()``, then 30
  zoom/pan events with a frame after each; a 256-row band through its
  renderer, then the ``d`` and ``t`` toggles once each through
  ``display_frame()``; then the stress page (``benchmarks/stress.py:93-124``):
  a 10k-character text on a 3840 x 2160 page zoomed out by 8 steps, and five
  frames zooming on from there, through ``PageRenderer.render_direct``;
- **page MSAA** (the session's ``m`` key): config 5's 31 frames again in a
  session with ``m`` pressed (the wide route: K8's pairs), a narrow session
  (640 x 480, six lines, ``m`` pressed, three events: the four-pass route)
  and the stress page's 6 frames through ``render_direct(msaa=True)``.
- **sharded path** (``fontrx_torch.engine.sharding``), after the checks
  below, on meshes of 4 shards laid over the visible cards round robin (all
  on ``cuda:0`` of one card): cjk64 through ``winding_sharded`` on glyphs
  and through ``winding_sharded_2d`` on 2 x 2 (32-row bands, K4's route in
  the reference), ascii256 padded to 96 glyphs on 2 x 2 (128-row bands),
  cjk64's 2 x 2 coverage, cjk32's SDF and ascii128's Loop-Blinn fill on
  glyphs, and config 5's first frame as page-space segments through
  ``page_rows_sharded`` on 4 row bands (1080 rows padded to 1536); then
  ``fontrx_torch.entry.dryrun_multichip(8)`` and ``dryrun_multihost(2, 4)``
  (two processes on the card, joined by gloo on localhost). Each result
  equals the same workload unsharded on every pixel (the SDF as int32 bit
  patterns, the page cropped), and the launches are counted exactly. Each
  sharded and unsharded call is timed, and ``winding()`` on each shard of
  cjk64's two meshes (the shards ``sharding.winding_shards`` cuts) and the
  coverage kernel on each cjk64 glyph shard, and the first shard of each
  other sharded launch (ascii256's ``winding()`` on 2 x 2, cjk32's SDF,
  ascii128's Loop-Blinn fill, config 5's first row band), from graph
  replays, beside its bound, each held to the plain version.
- **roofline probe** (K13): ``fontrx_torch.bench.roofline.run``, the
  port of ``tools/tpu_probes/tpu_roofline.py``: the four op mixes of
  ``csrc/roofline.cu`` at ``[16, 512, 128]`` x 1024 applications, each loop
  checked in ``cuobjdump -sass`` against the modelled instructions (an FMUL
  and an FADD and no FFMA; one add of 3 an application, no folded chain; an
  FSETP, an FSEL and an FADD) and timed beside its issue bound; the HBM
  bandwidth of ``base + dep`` over 256 MiB; ascii256's counted work bound
  under the data sheet's and the measured rates. Each mix's output equals
  the plain version bit for bit, and each kernel bound by operations above
  also gets its bound at the measured FP32 rate.
- **row-banded strip atlas** (K5 and K6, ``winding_banded()``):
  ``fontrx_torch.bench.banded``, the port of ``tools/tpu_probes/
  tpu_banded.py``, ``tpu_dense_banded.py`` and ``tpu_cjk_banded.py``: the
  6,022 glyphs of DejaVu Sans with 1-64 segments, x-sorted, at 64 px (two
  glyphs a 128-row strip) and 32 px (four), and the CJK benchmark batch
  (1000 x 288) at 64 and 32 px, each through ``winding_banded_batch``: four
  launches of ``winding_banded()`` and nothing else, no plain version. Each
  case's strips equal the plain version on the card and ``winding()`` per
  glyph on every pixel, and sampled glyphs the oracle; both kernels are timed
  beside their bounds.
- **edit path**, last (the session's ``char_input`` and ``backspace``, the
  incremental layout and the dirty-strip splice: K7 on 256-row bands):
  config 5's session through the edit script of
  ``tools/tpu_probes/tpu_interactive_edit.py`` (24 edits, every fourth a
  backspace) at the first view, then ``scroll(0.5, (0.1, 0.1))`` with 8
  edits, ``scroll(-8.0, (0, 0))`` with 4, and, since at 1920 x 1080 a line
  is taller than the band until the page is zoomed out by ~9.4 steps,
  ``scroll(-2.0)`` and a drag of the last line up to the first line's place
  with 8; a 480 x 480 session on two of its lines through the first three
  legs (it bands at the first view and after the zoom-in); the probe's
  10k-character page (150 paragraphs, default layout options) with the
  incremental layout on and off, 24 edits and 12 zoom/pan frames each.
  Every frame equals the plain version's page as the session's cache makes
  it (a band written into a copy of the page before), a frame at the first
  view also a fresh ``render_direct``; after a zoom its count against a
  fresh page is printed (``ROADMAP.md`` queue 3). A band frame is one
  launch of ``page()`` with 256 rows, a full frame one launch, a cached or
  off-screen one none; config 5's band leg and the narrow session's first
  two legs each band at least once. The band kernel, its
  ``render_direct(band=)`` call and the splice are timed.
- **command line**, last (``python -m fontrx_torch``, called in process as
  ``fontrx_torch.cli.main.main`` on the card's default backend): 'A' at 256
  px filled (BASELINE config 1) and gray, "Hello, World!" at 64 px as 2 x 2
  coverage (config 2), sdf, smooth (``--embolden 1.5``) and outline
  (``--stroke 3``), the triangulation of 'Q' at 128 px, of 'Ç' (its outline
  crosses itself: the winding fallback) and of 'Q' with ``-d`` (host NumPy,
  no launch), each once and 5 times warm; then ``-i`` on config 5's text
  from a StringIO stdin (a frame, a zoom, ``m``, ``m`` and one typed
  character). Each call's launches are counted (fill and gray one
  ``page()``, coverage one ``coverage.cu``, the SDF modes one ``winding()``
  and one ``sdf.cu``, the triangulation one ``loopblinn.cu`` or one
  ``winding()``; the loop three ``page()`` and one ``page_msaa()``) and no
  plain version may run. Each QOI's bytes equal the same argv's with
  ``--backend cpu``, config 1's page equals the oracle's fill on the page's
  own samples, and each frame of the loop equals the plain version's page;
  the values that a standard QOI decoder reads wrong in each file are
  counted (the encoder's index-slot fault, ROADMAP queue 3). The calls are
  timed: the first in the process, the median of the warm ones split into
  the font open, layout, render call, copy to host and QOI encode (host
  clock, synchronised), the kernels from CUDA-graph replays, and config 1 in
  a new ``python -m fontrx_torch`` process (the kernels already built).
- **colour path**, last (COLR v0 glyphs: the coverage kernel over every
  (glyph, layer) row, the src-over fold, the page composite): ``-m color``
  on ``tests/data/colrtest.ttf``'s "CAB\\nBCA" at 64 and 256 px in palettes
  0, 1 and dark, each once and 3 times warm (one coverage launch a call);
  config 5's session in ``mode="color"`` (its text, font and 30 events,
  then a zoom out that puts all 1,080 instances on the page) and 20 rows
  of colrtest's colour glyphs on 1920 x 1080 zoomed out until their tiles
  overlap (one coverage launch for each change of zoom); no plain version
  may run. Each file equals ``--backend cpu``'s bytes, the tiles of A, B
  and C at 64 px gate 10's NumPy oracle, each session's tiles at each zoom
  the plain version's, and each frame the plain serial composite of the
  plain tiles; the tile pass, the kernel and the composite (main path and
  plain) are timed at each session's first and last view.

It then checks every result: each kernel against its plain PyTorch version
on every pixel (the SDF as int32 bit patterns; the Loop-Blinn atlas also
against the plain version on the CPU; the windowed atlases also against
``winding.cu`` on the unwindowed batch), the atlases against the NumPy oracle
(``contract=False``; for the SDF, its sign) on sampled glyphs, the quick
start against the oracle's fill, the Loop-Blinn fill against the
winding fill at tie-free sample offsets on the glyphs of the JAX package's
own test (``tests/test_geometry.py``), and the pages against the plain
version (every frame, whole; config 5's band, gray and transparent frame; a
128-row band of the 4K page), the winding kernel at batch 1 (config 5's first
frame, whose transform is exact) and the oracle (every 64th row of that
frame), the MSAA frames against the plain version (every frame, whole), the
first config 5 and narrow MSAA frames against four winding-kernel passes at
the sample offsets, and config 5's against the oracle at the four offsets
(every 128th row from row 32; the oracle runs a row per process), and
times each kernel and its plain version with CUDA events: the kernel both
replayed from a CUDA graph (its device time) and called through its wrapper
(what a caller waits for, host launch overhead included; for the fill
atlases also the host's own time a call, ``call_host_ms``), and each
session's frames as its user sees them (``stats()``: the page to the host
included).
Each ``winding()`` and ``winding_windows()`` launch that it times (the
atlases, the quick start, ``entry()``, the windowed batches, the SDF's sign,
the K4 shards and the command line's) is printed with its launch plan
(``winding.plan``: rows a block, segments a chunk, cells a lane, shared
bytes).
Any failure raises and exits non-zero. The last two lines are JSON: the kernels' record (each
kernel's times beside its bound, from ``fontrx_torch.bound``, its launches
with the command line's among them, the host pack times and the command
line's record), then ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ast
import contextlib
import io
import json
import multiprocessing
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from itertools import repeat

import numpy as np
import torch

from fontrx_torch.bench import banded as banded_probe
from fontrx_torch.bench import roofline as roofline_probe
from fontrx_torch.bench.cjk import UPEM, make_batch
from fontrx_torch.bench.timing import cuda_ms, graph_ms, host_ms, synced_ms
from fontrx_torch.bound import (
    SDF_CULL_BOX, bound_ms, loopblinn_bytes, loopblinn_work, page_bytes, page_msaa_bytes,
    page_msaa_work, page_work, sdf_kept_pairs, sdf_work, winding_work, window_bytes, window_work)
from fontrx_torch.cli import main as cli
from fontrx_torch.convert import grid_anchors, packed_to_device, to_device, triangles_to_device
from fontrx_torch.device import probe, require_cuda
from fontrx_torch.engine import colorglyphs, sharding
from fontrx_torch.engine.atlas import pack_charset
from fontrx_torch.engine.raster import RasterEngine
from fontrx_torch.entry import dryrun_multichip, dryrun_multihost, entry
from fontrx_torch.font.font import Font
from fontrx_torch.geometry import TriangulatedGlyph
from fontrx_torch.io import qoi
from fontrx_torch.kernels import (
    _build, coverage, coverage_ref, loopblinn, loopblinn_ref, oracle, page, page_ref, roofline,
    roofline_ref, sdf, sdf_ref, winding, winding_ref)
from fontrx_torch.kernels.grid import RasterGrid
from fontrx_torch.pack.segments import glyph_segments, pack_glyph, xsort_segments
from fontrx_torch.scene.interactive import InteractiveSession
from fontrx_torch.scene.layout import layout_text
from fontrx_torch.scene.page import PageRenderer
from fontrx_torch.scene.transform import ViewTransform

ROOT = pathlib.Path(__file__).resolve().parent
DEJAVU = ROOT / "fontrx_torch" / "data" / "DejaVuSans.ttf"
CJK = ROOT / "tests" / "data" / "cjktest.ttf"

# (name, font, chars, font size = tile size)
ATLASES = (
    ("ascii256", DEJAVU, list(range(33, 127)), 256),
    ("cjk64", CJK, [0x4E00 + i for i in range(1024)], 64),
)
ORACLE_STRIDE = 13           # winding: every 13th glyph, as bench.py samples
COVERAGE_ORACLE_STRIDE = 52  # coverage costs the oracle k*k maps a glyph
SAMPLES = 2                  # k of the k x k coverage (the reference's MSAA workloads)
# (name, packed atlas, font size = tile size): BASELINE config 4, "SDF atlas
# for 1000 CJK glyphs at 32/64px", beside the ASCII headline atlas
SDF_ATLASES = (("ascii256", "ascii256", 256), ("cjk64", "cjk64", 64), ("cjk32", "cjk64", 32))
SDF_ORACLE_STRIDE = 52
# the window-packed atlas (K3): cjk64's batch at 64 and 32 px, and the
# reference's CJK benchmark batch (benchmarks/cjk.py:112-160, atlas(): 1000
# glyphs x 288 segments, seed 7, x-sorted per glyph, min_x 0, max_y size - 1)
# at 64 and 32 px
WINDOW_SIZES = (64, 32)
SYNTH_GLYPHS, SYNTH_SEGMENTS = 1000, 288
WINDOW_ORACLE_STRIDE = 52
# BASELINE config 3 (benchmarks/configs.py:138-197): the printable ASCII
# glyphs of DejaVu Sans, triangulated, at 128 px on 128 x 128 tiles
LB_CHARS = list(range(33, 127))
LB_SIZE = 128
# the JAX package's test of the mesh fill against the winding fill
# (tests/test_geometry.py::test_fill_matches_winding): these glyphs at 64 px,
# sampled at tie-free offsets
LB_WINDING_CHARS = "AOBg8@&WQ%"
LB_WINDING_SIZE = 64
LB_WINDING_OFFSET = (1 / 3, 1 / 3)
# BASELINE config 5 (benchmarks/configs.py:276-295): twenty lines on a
# 1920 x 1080 page in an interactive session, then 30 zoom/pan events; and
# the stress page
# (benchmarks/stress.py:93-124): the line below repeated to 10k characters
# on a 3840 x 2160 page, zoomed out by 8 steps, then five frames zooming in
CONFIG5_TEXT = "\n".join(
    "The quick brown fox jumps over the lazy dog 0123456789" for _ in range(20))
CONFIG5_SIZE = (1920, 1080)
CONFIG5_EVENTS = tuple(("scroll", 0.5 if i % 2 else -0.5, (0.1, 0.1)) if i % 3 == 0
                       else ("drag", 0.01, 0.005) for i in range(30))
STRESS_LINE = "The quick brown fox jumps over the lazy dog. 0123456789 "
STRESS_TEXT = "\n".join(STRESS_LINE for _ in range(10000 // len(STRESS_LINE)))
STRESS_SIZE = (3840, 2160)
PAGE_BAND = (400, 256)        # config 5's band: rows [400, 656)
STRESS_REF_BAND = (1016, 128)  # the 4K page's rows held to the plain version
PAGE_ORACLE_STRIDE = 64
# the MSAA oracle's rows of config 5's first MSAA frame: every 128th from 32
MSAA_ORACLE_ROWS = range(32, CONFIG5_SIZE[1], 128)
# a session below the wide route: six lines on 640 x 480, m pressed, three events
NARROW_TEXT = "\n".join(
    "The quick brown fox jumps over the lazy dog 0123456789" for _ in range(6))
NARROW_SIZE = (640, 480)
NARROW_EVENTS = (("scroll", -0.5, (0.1, 0.1)), ("drag", 0.01, 0.005), ("scroll", 0.5, (0.0, 0.2)))

# the edit phase (the session's char_input and backspace, the dirty-strip
# splice): the edit script of tools/tpu_probes/tpu_interactive_edit.py:27-89,
# 24 edits, every fourth a backspace of one cluster, else one of "abcdefgh",
# then 12 zoom/pan frames; legs (name, zoom before the leg's edits, edits):
# config 5's session at the first view, after scroll(0.5, (0.1, 0.1)) and
# after scroll(-8.0, (0, 0)). At 1920 x 1080 a line is 1,117 rows tall at the
# first view, so no edit fits the 256-row band until the page is zoomed out
# by ~9.4 steps: the "band" leg zooms out by 2 more and drags the last line
# up to where the first line was.
EDIT_FRAMES = 24
ZOOM_PAN_FRAMES = 12
EDIT_LEGS = (("first", None, EDIT_FRAMES), ("zoom-in", (0.5, (0.1, 0.1)), 8),
             ("zoom-out", (-8.0, (0.0, 0.0)), 4), ("band", (-2.0, (0.0, 0.0)), 8))
# a spliced page equals a fresh one at the first view; after a zoom a band's
# rows may differ from the full page's, in both packages (ROADMAP.md queue 3)
EDIT_FRESH_LEGS = ("first",)
# the band path at the first view and after the zoom-in: config 5's first
# two lines on 480 x 480 (a line 279 rows tall; the last one on the page)
EDIT_NARROW_TEXT = "\n".join(CONFIG5_TEXT.split("\n")[:2])
EDIT_NARROW_SIZE = (480, 480)
# the probe's 10k-character page: PARA x 150 on 1920 x 1080, default options
PROBE_PARA = "The quick brown fox jumps over the lazy dog, flying off 0123456789."
PROBE_TEXT = "\n".join(PROBE_PARA for _ in range(150))

# the command line (python -m fontrx_torch), in process, last: (name, the argv
# after -f DejaVu Sans, the kernels one call launches). BASELINE config 1 ('A'
# at 256 px, fill) and config 2 ("Hello, World!" at 64 px, 2 x 2 coverage),
# then every other ported mode; 'Ç' is a glyph whose outline crosses itself,
# so its triangulation falls back to the winding fill
CLI_TEXT = "Hello, World!"
CLI_CASES = (
    ("config1", ["-t", "A", "-s", "256"], {"page": 1}),
    ("gray", ["-t", "A", "-s", "256", "-m", "gray"], {"page": 1}),
    ("config2", ["-t", CLI_TEXT, "-s", "64", "-m", "coverage", "--samples", "2"],
     {"coverage": 1}),
    ("sdf", ["-t", CLI_TEXT, "-s", "64", "-m", "sdf"], {"winding": 1, "sdf": 1}),
    ("smooth", ["-t", CLI_TEXT, "-s", "64", "-m", "smooth", "--embolden", "1.5"],
     {"winding": 1, "sdf": 1}),
    ("outline", ["-t", CLI_TEXT, "-s", "64", "-m", "outline", "--stroke", "3"],
     {"winding": 1, "sdf": 1}),
    ("triangulation", ["-t", "Q", "-s", "128", "-m", "triangulation"], {"loopblinn": 1}),
    ("self_crossing", ["-t", "Ç", "-s", "128", "-m", "triangulation"], {"winding": 1}),
    ("debug", ["-t", "Q", "-s", "128", "-m", "triangulation", "-d"], {}),
)
# the call also timed in a new python -m fontrx_torch process (the start-up of
# Python, torch and the card is the same for every mode)
CLI_COLD = "config1"
CLI_WARM = 5  # warm in-process calls a case, after its first
# the -i loop: config 5's text on 1920 x 1080, a zoom, m, one typed character
CLI_SCRIPT = ("frame", "scroll 0.5 0.1 0.1", "frame", "key m", "frame", "key m", "type x",
              "frame", "stats", "quit")
# the plain versions a wrapper runs on a CPU tensor: none may run on the card
PLAIN_FUNCTIONS = ((winding_ref, "winding_batch"), (coverage_ref, "coverage_batch"),
                   (sdf_ref, "sdf_batch"), (sdf_ref, "sdf_from_winding"),
                   (loopblinn_ref, "loopblinn_batch"), (page_ref, "direct_page"),
                   (page_ref, "direct_page_msaa"), (winding_ref, "winding_banded_batch"),
                   (colorglyphs, "serial_fold"))

# the colour phase (COLR v0 glyphs, engine/colorglyphs.py), after the command
# line: tests/data/colrtest.ttf's A, B and C have two layers each (B's second
# at 50% alpha, C's second in the foreground colour). The command line on
# "CAB\nBCA" at 64 and 256 px in palettes 0, 1 and dark, then two 1920 x 1080
# sessions in colour mode: config 5's (its text, font and 30 events, then a
# zoom out that puts all 1,080 instances on the page) and 20 rows of the colour
# glyphs (1,080 instances, two layers each), zoomed out until their tiles
# overlap, then two pans
COLRTEST = ROOT / "tests" / "data" / "colrtest.ttf"
COLOR_TEXT = "CAB\nBCA"
COLOR_CLI = tuple((f"colr{size}_{pal}", ["-f", str(COLRTEST), "-t", COLOR_TEXT, "-s", str(size),
                                         "-m", "color", "--palette", pal])
                  for size in (64, 256) for pal in ("0", "1", "dark"))
COLOR_ROWS_TEXT = "\n".join("ABCCABBCA" * 6 for _ in range(20))
COLOR_SESSIONS = (
    ("config5", DEJAVU, CONFIG5_TEXT, CONFIG5_EVENTS + (("scroll", -22.0, (-1.0, 1.0)),)),
    ("colr_rows", COLRTEST, COLOR_ROWS_TEXT,
     (("scroll", -24.0, (-1.0, 1.0)), ("drag", 0.01, 0.005), ("drag", -0.02, 0.0))),
)
COLOR_WARM = 3  # warm calls of a CLI case, after its first

# the sharded phase: 4-shard meshes (glyphs, 2 x 2 glyphs x rows, row bands)
# laid over the visible cards round robin, the dry runs' mesh and processes
SHARDS = 4
DRYRUN_SHARDS = 8
MULTIHOST = (2, 4)  # processes, shards each

KERNELS = (winding, coverage, sdf, loopblinn, page, roofline)


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    for module in KERNELS:
        module.launches = 0
    page.msaa_launches = 0
    winding.windows_launches = 0
    winding.banded_launches = 0


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip smoke failed: {what}")


def sdf_bound(args, out):
    """The SDF distance kernel's bound in ms, what binds it, and the FP32
    operations and pairs counted: the segments, anchors and winding map read
    once and the output written once, against the operations of the
    (segment, pixel) pairs the function needs (``fontrx_torch.bound.sdf_work``,
    counted on the card)."""
    seg, min_x, max_y, scale = args
    nbytes = sum(t.numel() * t.element_size() for t in (seg, min_x, max_y, out))
    nbytes += out.numel() * 4  # the int32 winding map
    ops, pairs = sdf_work(seg, min_x, max_y, scale, height=out.shape[1], width=out.shape[2])
    return (*bound_ms(nbytes, ops), ops, pairs)


def coverage_oracle(segments, grid: RasterGrid, k: int) -> np.ndarray:
    """The oracle's coverage: nonzero samples over the k x k lattice,
    counted, times float32(1 / k^2)."""
    count = np.zeros((grid.height, grid.width), np.int32)
    scale = np.float32(grid.scale)
    for ox, oy in coverage_ref.sample_offsets(k):
        xs = ((grid.min_x + np.arange(grid.width)).astype(np.float32) + ox) / scale
        ys = ((grid.max_y - np.arange(grid.height)).astype(np.float32) + oy) / scale
        count += oracle.winding_at(segments, xs[None, :], ys[:, None], contract=False) != 0
    return count.astype(np.float32) * coverage_ref.inv_samples(k)


def build_kernels() -> None:
    """Build every kernel library at once, one nvcc process per source."""
    names = sorted(_build._SIGNATURES)

    def timed(name):
        cached = _build.library_path(name).exists()
        t0 = time.perf_counter()
        path = _build.build(name)
        return path, time.perf_counter() - t0, cached

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        results = dict(zip(names, pool.map(timed, names)))
    for name, (path, secs, cached) in results.items():
        _build.load(name)
        print(f"build: {path.relative_to(ROOT)} in {secs:.2f} s"
              + (" (already built)" if cached else ""))
    print(f"build: all kernels in {time.perf_counter() - t0:.2f} s")


def load_atlas(font_path, chars, size):
    t0 = time.perf_counter()
    font = Font.open(font_path)
    batch = pack_charset(font, chars)
    pack_s = time.perf_counter() - t0
    grids = [
        RasterGrid.fixed_tile(tuple(box), size, font.info.units_per_em, size)
        for box in np.asarray(batch.boxes)
    ]
    return batch, grids, pack_s


def load_meshes(font_path, chars, size):
    """Triangulate ``chars`` and pad their meshes to one triangle count, as
    ``benchmarks/configs.py:152-176`` does: float32 ``[B, M, 3, 4]`` and
    int32 ``[B, M]``, the fixed ``size`` grids, the host time."""
    t0 = time.perf_counter()
    font = Font.open(font_path)
    glyphs = [font.get_glyph(c)[0] for c in chars]
    meshes = [TriangulatedGlyph.from_glyph(g) for g in glyphs]
    tris, classes = loopblinn.pack_meshes(meshes)
    pack_s = time.perf_counter() - t0
    grids = [RasterGrid.fixed_tile((g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max),
                                   size, font.info.units_per_em, size) for g in glyphs]
    return tris, classes, grids, pack_s


def open_session(font, text, size, dev):
    """Open an interactive session on ``text`` and compact its segment stream
    (once per layout); returns the session and the host time."""
    t0 = time.perf_counter()
    sess = InteractiveSession(font, text, *size, dev)
    sess.renderer.page_inputs(sess.view)
    torch.cuda.synchronize()
    return sess, time.perf_counter() - t0


def run_events(sess, events):
    """A frame, then ``events`` with a frame after each: the frames (host
    arrays) and the view of each."""
    frames, views = [sess.frame()], [sess.view]
    for name, *args in events:
        getattr(sess, name)(*args)
        frames.append(sess.frame())
        views.append(sess.view)
    return frames, views


def stress_views(upem):
    """The stress page's first view, zoomed out by 8 steps, and its five
    frames zooming on (benchmarks/stress.py:108-124)."""
    view = ViewTransform.init(upem, *STRESS_SIZE).zoomed(-8.0, (0.0, 0.0))
    return [view] + [view.zoomed(0.01 * (i + 1), (0.0, 0.0)) for i in range(5)]


def load_page(font, text, size, view, dev):
    """Lay ``text`` out, make its page renderer and compact its segment
    stream (once per layout); returns the renderer and the host time."""
    t0 = time.perf_counter()
    renderer = PageRenderer(font, layout_text(font, text), *size, dev)
    renderer.page_inputs(view)
    torch.cuda.synchronize()
    return renderer, time.perf_counter() - t0


def winding_page(inputs, page_h, page_w, sample_offset=(0.0, 0.0)):
    """The page from the winding kernel at batch 1 on the page-space stream
    (anchors 0 and ``page_h - 1``, scale 1) at ``sample_offset``: int32
    ``[page_h, page_w]``. It solves every (segment, row) pair, so it is the
    page where no root strays."""
    flat = page_ref.transform_segments(*inputs)[None].contiguous()
    dev = flat.device
    return winding.winding_batch(
        flat, torch.zeros(1, dtype=torch.int32, device=dev),
        torch.full((1,), page_h - 1, dtype=torch.int32, device=dev), 1.0,
        height=page_h, width=page_w, sample_offset=sample_offset)[0]


def msaa_from_windings(windings):
    """The MSAA pixel from the four samples' int32 windings: nonzero ones
    counted, times 255, floor-divided by 4."""
    return sum(w != 0 for w in windings) * 255 // 4  # sum() starts at int 0


def oracle_row(q, xs, y):
    """The oracle's winding (``contract=False``) of page-space segments ``q``
    on one sample row ``y`` at columns ``xs``: int32 ``[1, len(xs)]``."""
    return oracle.winding_at(q, xs[None, :], np.float32([[y]]), contract=False)


def oracle_rows(q, page_w, rows):
    """The oracle on sample rows ``rows``, ``(y, ox)`` each, at columns
    ``x = f32(c) + ox``: int32 ``[len(rows), page_w]``. A row per process of
    a pool as wide as the host's cores (forked: the workers run NumPy only),
    a pool that ends with the call."""
    cols = np.arange(page_w).astype(np.float32)
    with ProcessPoolExecutor(os.cpu_count() or 1,
                             mp_context=multiprocessing.get_context("fork")) as pool:
        return np.concatenate(list(pool.map(
            oracle_row, repeat(q), [cols + np.float32(ox) for _, ox in rows],
            [y for y, _ in rows])))


def counts() -> dict:
    """Every kernel's launch count."""
    return {"winding": winding.launches, "coverage": coverage.launches, "sdf": sdf.launches,
            "loopblinn": loopblinn.launches, "page": page.launches,
            "page_msaa": page.msaa_launches, "winding_windows": winding.windows_launches,
            "winding_banded": winding.banded_launches}


def pad_batch(n, *arrays, fill=0):
    """Each array padded along dim 0 to ``n`` with ``fill`` (empty glyphs).
    ``fill`` is a value, or one per array."""
    fills = fill if isinstance(fill, tuple) else (fill,) * len(arrays)
    return tuple(torch.cat([a, a.new_full((n - len(a), *a.shape[1:]), f)])
                 for a, f in zip(arrays, fills))


def sharded_phase(dev, atlases, outputs, cov_outputs, sdf_atlases, sdf_outputs, lb_args,
                  lb_out, config5):
    """Drive the sharded path (``fontrx_torch.engine.sharding``) on the
    workloads above, split over 4-shard meshes, and hold each to the same
    workload unsharded; then the two dry runs. Returns the record (the dry
    runs' launches in it) and the launches of the sharded workloads."""
    mesh = sharding.make_mesh(SHARDS)
    mesh22 = sharding.make_mesh_2d(2, SHARDS // 2)
    rows = sharding.make_row_mesh(SHARDS)
    cjk, cjk_grids, _ = atlases["cjk64"]
    cjk_args = packed_to_device(cjk, cjk_grids, dev)
    ascii_batch, ascii_grids, _ = atlases["ascii256"]
    ascii_args = packed_to_device(ascii_batch, ascii_grids, dev)
    n_ascii = -(-len(ascii_grids) // SHARDS) * SHARDS
    ascii_padded = (*pad_batch(n_ascii, *ascii_args[:3]), ascii_args[3])
    sdf_batch, sdf_grids, _ = sdf_atlases["cjk32"]
    sdf_args = packed_to_device(sdf_batch, sdf_grids, dev)
    lb_padded = (*pad_batch(n_ascii, *lb_args[:4], fill=(0.0, loopblinn_ref.CLASS_PAD, 0, 0)),
                 lb_args[4])
    sess5, view5, frame5 = config5
    h5, w5 = sess5.renderer.height, sess5.renderer.width
    inputs5 = sess5.renderer.page_inputs(view5)
    flat5 = page_ref.transform_segments(*inputs5)[None].contiguous()
    one = (torch.zeros(flat5.shape[1], dtype=torch.int32, device=dev),
           torch.zeros((1, 2), dtype=torch.float32, device=dev))

    # name -> (sharded call, its mesh, the whole result from the shards, the
    # unsharded call, the unsharded result the phase already has)
    work = {
        "cjk64_glyphs4": (
            lambda: sharding.winding_sharded(*cjk_args, height=64, width=64, mesh=mesh), mesh,
            lambda out: sharding.gather(mesh, out),
            lambda: winding.winding_batch(*cjk_args, height=64, width=64),
            outputs["cjk64"]),
        "cjk64_2x2": (
            lambda: sharding.winding_sharded_2d(*cjk_args, height=64, width=64, mesh=mesh22),
            mesh22, lambda out: sharding.gather(mesh22, out),
            lambda: winding.winding_batch(*cjk_args, height=64, width=64),
            outputs["cjk64"]),
        "ascii256_2x2": (
            lambda: sharding.winding_sharded_2d(*ascii_padded, height=256, width=256,
                                                mesh=mesh22),
            mesh22, lambda out: sharding.gather(mesh22, out),
            lambda: winding.winding_batch(*ascii_args, height=256, width=256),
            outputs["ascii256"]),
        "cjk64_coverage_glyphs4": (
            lambda: sharding.coverage_sharded(*cjk_args, height=64, width=64, samples=SAMPLES,
                                              mesh=mesh),
            mesh, lambda out: sharding.gather(mesh, out),
            lambda: coverage.coverage_batch(*cjk_args, height=64, width=64, samples=SAMPLES),
            cov_outputs["cjk64"][0]),
        "cjk32_sdf_glyphs4": (
            lambda: sharding.sdf_sharded(*sdf_args, height=32, width=32, mesh=mesh), mesh,
            lambda out: sharding.gather(mesh, out).view(torch.int32),  # bit patterns
            lambda: sdf.sdf_batch(*sdf_args, height=32, width=32),
            sdf_outputs["cjk32"][0].view(torch.int32)),
        "ascii128_loopblinn_glyphs4": (
            lambda: sharding.loopblinn_sharded(*lb_padded, height=LB_SIZE, width=LB_SIZE,
                                               mesh=mesh),
            mesh, lambda out: sharding.gather(mesh, out),
            lambda: loopblinn.loopblinn_batch(*lb_args, height=LB_SIZE, width=LB_SIZE),
            lb_out),
        "config5_rows4": (
            lambda: sharding.page_rows_sharded(flat5, h5, w5, mesh=rows), rows,
            lambda out: page_ref.finish(sharding.gather(rows, out)[:h5, :w5], "fill"),
            lambda: page.direct_page(flat5[0], *one, 1.0, page_h=h5, page_w=w5),
            frame5),
    }
    reset_counts()
    results = {name: call() for name, (call, *_) in work.items()}
    torch.cuda.synchronize()
    launches = counts()
    # winding(): cjk64 on glyphs, cjk64 and ascii256 on 2 x 2, the SDF's sign
    want = {"winding": 4 * SHARDS, "coverage": SHARDS, "sdf": SHARDS, "loopblinn": SHARDS,
            "page": SHARDS, "page_msaa": 0, "winding_windows": 0, "winding_banded": 0}
    check(launches == want, f"the sharded path launched {launches}, not {want}")
    print(f"sharded path: launches {json.dumps(launches)} (winding(): {SHARDS} shards each of "
          "cjk64 on glyphs, cjk64 on 2 x 2, ascii256 on 2 x 2, and the SDF's sign)")

    record = {}
    for name, (call, on, whole, single, unsharded) in work.items():
        shards = results[name]
        check([t.device for t in shards] == on.flat(), f"{name}: a shard is off its device")
        got = whole(shards)
        pad = got[len(unsharded):]  # the padding glyphs: empty
        check(not pad.any(), f"{name}: a padding glyph has ink")
        got = got[: len(unsharded)]
        check(got.shape == unsharded.shape, f"{name}: shape {tuple(got.shape)}")
        diff = int((got != unsharded).sum())
        check(diff == 0, f"{name}: {diff} pixels differ from the unsharded result")
        call_ms = cuda_ms(call, inner=10)
        single_ms = cuda_ms(single, inner=10)
        record[name] = dict(call_ms=call_ms, unsharded_call_ms=single_ms, shards=len(shards),
                            padding_glyphs=len(pad))
        print(f"sharded {name}: {len(shards)} shards, 0 of {got.numel()} pixels differ from "
              f"the unsharded result ({len(pad)} padding glyphs empty); sharded call "
              f"{call_ms:.4f} ms, unsharded call {single_ms:.4f} ms (CUDA events)")

    # K4's function: winding() on each shard of cjk64's glyph mesh and of its
    # 2 x 2 mesh (32-row bands), as sharding.winding_shards cuts them for
    # winding_sharded(_2d), held to the plain version and timed (graph
    # replays, wrapper calls, the plain version) beside each shard's bound
    scale = cjk_args[3]
    for name, on in (("cjk64_glyphs4", mesh), ("cjk64_2x2", mesh22)):
        rec = []
        for s in sharding.winding_shards(*cjk_args[:3], height=64, mesh=on):
            shard = (s.segments, s.min_x, s.max_y, scale)
            ops, nbytes, _ = winding_work(cjk.segments[s.glyphs], cjk.seg_counts[s.glyphs],
                                          s.max_y, scale, height=s.rows, width=64)
            b_ms, bound_by = bound_ms(nbytes, ops)

            def kernel(shard=shard, rows=s.rows):
                return winding.winding_batch(*shard, height=rows, width=64)

            def plain(shard=shard, rows=s.rows):
                return winding_ref.winding_batch(*shard, height=rows, width=64)

            check(torch.equal(kernel(), plain()),
                  f"{name}: the shard of glyphs {s.glyphs} at row {s.row0} differs from the "
                  "plain version")
            rec.append(dict(ms=graph_ms(kernel), call_ms=cuda_ms(kernel, inner=10),
                            plain_ms=cuda_ms(plain, inner=1, reps=3, warmup=1),
                            bound_ms=b_ms, bound_by=bound_by, bound_ops=ops))
        record[name].update({f"shard_{key}": [f[key] for f in rec] for key in rec[0]})
        m, band_h = len(s.segments), s.rows
        print(f"sharded {name}: winding() per shard ({m} glyphs x {band_h} rows, "
              f"{plan_text(m, band_h, 64)}), equal to the "
              "plain version; graph replay / wrapper call / plain version, bound: "
              + ", ".join(f"{f['ms']:.4f} / {f['call_ms']:.4f} / {f['plain_ms']:.2f} ms, "
                          f"{f['bound_ms']:.5f} ms ({f['bound_by']})" for f in rec))

    # the coverage kernel on each shard of cjk64's glyph mesh, as
    # coverage_sharded cuts them, held to the plain version and timed beside
    # each shard's bound
    rec = []
    offsets = coverage_ref.sample_offsets(SAMPLES)[::SAMPLES, 1]
    quarter = len(cjk.segments) // SHARDS
    for k, (seg, mx, my) in enumerate(zip(*sharding.shard_batch(mesh, *cjk_args[:3]))):
        part = slice(k * quarter, (k + 1) * quarter)
        ops, nbytes, _ = winding_work(cjk.segments[part], cjk.seg_counts[part], my, scale,
                                      height=64, width=64, row_offsets=offsets,
                                      columns=SAMPLES, samples_per_pixel=SAMPLES * SAMPLES)
        b_ms, bound_by = bound_ms(nbytes, ops)

        def kernel(shard=(seg, mx, my, scale)):
            return coverage.coverage_batch(*shard, height=64, width=64, samples=SAMPLES)

        check(torch.equal(kernel(), coverage_ref.coverage_batch(
            seg, mx, my, scale, height=64, width=64, samples=SAMPLES)),
              f"cjk64 coverage shard {k} differs from the plain version")
        rec.append(dict(ms=graph_ms(kernel), bound_ms=b_ms, bound_by=bound_by, bound_ops=ops))
    record["cjk64_coverage_glyphs4"].update(
        {f"shard_{key}": [f[key] for f in rec] for key in rec[0]})
    print("sharded cjk64_coverage_glyphs4: coverage kernel per shard, equal to the plain "
          "version; graph replay, bound: " + ", ".join(
              f"{f['ms']:.4f} ms, {f['bound_ms']:.5f} ms ({f['bound_by']})" for f in rec))

    # the first shard of each other sharded launch (ascii256's winding() on 2 x
    # 2, the SDF's glyph shards, the Loop-Blinn fill's and config 5's row
    # bands), as sharding cuts it, held to the plain version and timed (graph
    # replays) beside its bound: the shards share one shape, so the loss
    # column counts every sharded launch at this time
    s = sharding.winding_shards(*ascii_padded[:3], height=256, mesh=mesh22)[0]
    a_scale = ascii_args[3]
    ops, nbytes, _ = winding_work(ascii_batch.segments[s.glyphs],
                                  ascii_batch.seg_counts[s.glyphs], s.max_y, a_scale,
                                  height=s.rows, width=256)
    one_shard = {"ascii256_2x2": (
        lambda: winding.winding_batch(s.segments, s.min_x, s.max_y, a_scale, height=s.rows,
                                      width=256),
        lambda: winding_ref.winding_batch(s.segments, s.min_x, s.max_y, a_scale,
                                          height=s.rows, width=256),
        bound_ms(nbytes, ops), f"{len(s.segments)} glyphs x {s.rows} rows, "
                               f"{plan_text(len(s.segments), s.rows, 256)}")}
    seg, mx, my = (a[0] for a in sharding.shard_batch(mesh, *sdf_args[:3]))
    sdf_shard = (seg, mx, my, sdf_args[3])
    one_shard["cjk32_sdf_glyphs4"] = (
        lambda: sdf.sdf_batch(*sdf_shard, height=32, width=32),
        lambda: sdf_ref.sdf_batch(*sdf_shard, height=32, width=32),
        sdf_bound(sdf_shard, sdf.sdf_batch(*sdf_shard, height=32, width=32))[:2],
        f"{len(seg)} glyphs of 32 x 32")
    lb_shard = (*(a[0] for a in sharding.shard_batch(mesh, *lb_padded[:4])), lb_padded[4])
    ops, _ = loopblinn_work(*lb_shard, height=LB_SIZE, width=LB_SIZE)
    one_shard["ascii128_loopblinn_glyphs4"] = (
        lambda: loopblinn.loopblinn_batch(*lb_shard, height=LB_SIZE, width=LB_SIZE),
        lambda: loopblinn_ref.loopblinn_batch(*lb_shard, height=LB_SIZE, width=LB_SIZE),
        bound_ms(loopblinn_bytes(lb_shard[1], LB_SIZE, LB_SIZE), ops),
        f"{len(lb_shard[0])} glyphs, {lb_plan_text(*lb_shard[0].shape[:2], LB_SIZE, LB_SIZE)}")
    pw = -(-w5 // sharding.PAGE_TILE_W) * sharding.PAGE_TILE_W
    rows_per = -(-h5 // (sharding.PAGE_STRIP_ROWS * SHARDS)) * sharding.PAGE_STRIP_ROWS
    band = (flat5[0], *one, 1.0, 0)
    ops, _, _ = page_work(*band, page_h=h5, page_w=pw, out_h=rows_per)
    one_shard["config5_rows4"] = (
        lambda: page.direct_page(*band, page_h=h5, page_w=pw, out_h=rows_per, mode="winding"),
        lambda: page_ref.direct_page(*band, page_h=h5, page_w=pw, out_h=rows_per,
                                     mode="winding"),
        bound_ms(page_bytes(len(flat5[0]), 1, rows_per, pw, "winding"), ops),
        f"rows 0-{rows_per - 1} of {h5} x {pw}")
    for name, (kernel, plain, (b_ms, bound_by), what) in one_shard.items():
        got = kernel()
        check(torch.equal(bits(got), bits(plain())),
              f"{name}: its first shard differs from the plain version")
        check(torch.equal(bits(got), bits(results[name][0])),
              f"{name}: its first shard differs from the sharded call's")
        rec = dict(ms=graph_ms(kernel), plain_ms=cuda_ms(plain, inner=1, reps=3, warmup=1),
                   bound_ms=b_ms, bound_by=bound_by, shards_timed=1)
        record[name].update({f"shard_{key}": value for key, value in rec.items()})
        print(f"sharded {name}: its first shard ({what}) equal to the plain version and to "
              f"the sharded call's; graph replay {rec['ms']:.4f} ms, bound {b_ms:.5f} ms "
              f"({bound_by}), plain version {rec['plain_ms']:.2f} ms")

    reset_counts()
    t0 = time.perf_counter()
    dryrun_multichip(DRYRUN_SHARDS)
    torch.cuda.synchronize()
    multichip_s = time.perf_counter() - t0
    dry = counts()
    n = DRYRUN_SHARDS
    want = {"winding": 4 * n, "coverage": n, "sdf": n, "loopblinn": n, "page": n,
            "page_msaa": 0, "winding_windows": 0, "winding_banded": 0}
    check(dry == want, f"dryrun_multichip({n}) launched {dry}, not {want}")
    t0 = time.perf_counter()
    gathered, host_launches = dryrun_multihost(*MULTIHOST)
    multihost_s = time.perf_counter() - t0
    check(host_launches == [MULTIHOST[1]] * MULTIHOST[0],
          f"dryrun_multihost{MULTIHOST}: winding() launches per rank {host_launches}")
    check(gathered.shape == (2 * MULTIHOST[0] * MULTIHOST[1], 8, 128) and gathered.any(),
          "dryrun_multihost: the gathered map")
    print(f"dryrun_multichip({n}): passed in {multichip_s:.2f} s, launches {json.dumps(dry)}; "
          f"dryrun_multihost{MULTIHOST}: passed in {multihost_s:.2f} s (gloo on localhost, "
          f"process start-up included), winding() launches per rank {host_launches}")
    record["dryruns"] = dict(multichip_s=multichip_s, multichip_launches=dry,
                             multihost_s=multihost_s, multihost_launches=host_launches)
    return record, launches


def bits(t):
    """A float32 tensor's int32 bit patterns (so -0.0 and +0.0 differ); any
    other tensor as it is."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def roofline_phase(dev, record, ascii256):
    """The roofline probe (K13), the port of ``tools/tpu_probes/
    tpu_roofline.py``: ``fontrx_torch.bench.roofline.run`` on the
    ``(batch, grids)`` of ascii256 packed above, with the launch counts set
    to 0 just before it; then each mix's output held to the plain
    version bit for bit, and the plain version timed. Each kernel above bound
    by operations also gets its bound at the measured f32 mul+add rate.
    Returns the kernels line's entry."""
    reset_counts()
    result, outputs = roofline_probe.run(ascii256, dev)
    torch.cuda.synchronize()
    launches = roofline.launches
    # per mix: the result, graph_ms's warm-up and the captured calls
    want = len(roofline_ref.MIXES) * (2 + roofline_probe.CALLS)
    check(launches == want, f"the roofline probe launched its kernel {launches} times, not {want}")
    check(not any(counts().values()), f"the roofline probe launched {counts()}")
    roofline_probe.report(result)

    max_err = 0.0
    for mix, (x, out) in outputs.items():
        m = result["mixes"][mix]
        ref = roofline_ref.elementwise(mix, x, roofline_probe.ITERS)
        check(out.shape == ref.shape == x.shape and out.dtype == ref.dtype == x.dtype,
              f"roofline {mix}: shape or type")
        diff = int((bits(out) != bits(ref)).sum())
        max_err = max(max_err, float((out.double() - ref.double()).abs().max()))
        check(diff == 0, f"roofline {mix}: {diff} elements differ from the plain version (bits)")
        m["plain_ms"] = cuda_ms(
            lambda mix=mix, x=x: roofline_ref.elementwise(mix, x, roofline_probe.ITERS),
            inner=1, reps=3, warmup=1)
        nbytes = 2 * x.numel() * x.element_size()
        m["bound_ms"], m["bound_by"] = bound_ms(nbytes, m["ops"])
        print(f"roofline {mix}: {out.numel()} elements equal the plain version bit for bit "
              f"({int(bits(out)[0, 0, 0])}); plain version {m['plain_ms']:.3f} ms; bound "
              f"{m['bound_ms']:.5f} ms ({m['bound_by']}; {nbytes} B, {m['ops']} ops at the data "
              "sheet's FP32 rate)")

    # the kernels above bound by operations, at the measured single-op FP32 rate
    rate = result["mixes"]["f32_mul_add"]["tops"] * 1e12
    at_rate = {f"{kname}/{atlas}": rec["bound_ops"] / rate * 1e3
               for kname, per in record.items() for atlas, rec in per.items()
               if rec.get("bound_by") == "operations"}
    for name, ms in at_rate.items():
        kname, atlas = name.split("/")
        print(f"roofline: {name} bound {record[kname][atlas]['bound_ms']:.4f} ms at 67 TFLOP/s, "
              f"{ms:.4f} ms at the measured {rate / 1e12:.2f} T op/s (information only)")

    # the f32 mul+add mix in the main keys, the other mixes beside them
    mixes = dict(result.pop("mixes"))
    mix = "f32_mul_add"
    return {"name": "roofline", "route": "cuda", "source": roofline.SOURCE,
            "replaces": "tools/tpu_probes/tpu_roofline.py:59", "launches": launches,
            "max_abs_err": max_err, "mix": mix, **mixes.pop(mix), "library_ms": None,
            "mixes": mixes, **result, "operations_bound_at_measured_fp32_ms": at_rate}


BANDED_ORACLE_STRIDE = 251  # every 251st glyph of each banded case against the oracle


def banded_phase(dev):
    """The row-banded strip atlas (K5 and K6 on ``winding_banded()``):
    ``fontrx_torch.bench.banded``'s four cases, the strips of each through
    ``winding_banded_batch`` once, with the launch counts set to 0 just before
    and read just after: one launch of ``winding_banded()`` a case, no other
    kernel and no plain version. Then each case's strips are held to the
    plain version on the card and to ``winding()`` per glyph (the probe's
    A/B), both on every pixel, and every ``BANDED_ORACLE_STRIDE``-th glyph to
    the oracle; both kernels and the plain version are timed. Returns the
    record by case, the launches, the largest error and the host seconds of
    building the cases."""
    t0 = time.perf_counter()
    cases = banded_probe.cases()
    build_s = time.perf_counter() - t0
    inputs = {c.name: banded_probe.strip_inputs(c, dev) for c in cases}
    reset_counts()
    with counting_plain() as plain:
        outs = {c.name: banded_probe.strips(c, inputs[c.name]) for c in cases}
        torch.cuda.synchronize()
    launches = counts()
    check(plain[0] == 0, f"the banded path ran a plain version {plain[0]} times on the card")
    check(launches == {**dict.fromkeys(launches, 0), "winding_banded": len(cases)},
          f"the banded path launched {launches}, not winding_banded() {len(cases)} times")
    print(f"banded path: {launches['winding_banded']} winding_banded() launches, nothing else, "
          f"0 plain-version runs; host build of the cases {build_s:.3f} s")

    record, max_err = {}, 0
    for case in cases:
        sargs, out = inputs[case.name], outs[case.name]
        b = len(case.strip[0])
        check(out.shape == (b, 128, case.size) and out.dtype == torch.int32,
              f"{case.name} strip shape")
        ref = winding_ref.winding_banded_batch(*sargs, width=case.size)
        diff = int((out != ref).sum())
        max_err = max(max_err, int((out - ref).abs().max()))
        check(diff == 0, f"{case.name}: {diff} pixels differ from the plain version")
        gargs = banded_probe.glyph_inputs(case, dev)
        rec = banded_probe.measure(case, sargs, gargs, out, banded_probe.per_glyph(case, gargs))
        check(rec["differ"] == 0,
              f"{case.name}: {rec['differ']} pixels differ from winding() per glyph")
        maps = banded_probe.strip_maps(case, out).cpu().numpy()
        segs, live, min_x, max_y = case.glyph
        sampled = range(0, case.glyphs, BANDED_ORACLE_STRIDE)
        mism = 0
        for i in sampled:
            xs = (min_x[i] + np.arange(case.size)).astype(np.float32) / case.scale
            ys = (max_y[i] - np.arange(case.size)).astype(np.float32) / case.scale
            wo = oracle.winding_at(segs[i, : live[i]], xs[None, :], ys[:, None],
                                   contract=False)
            mism += int((wo != maps[i]).sum())
        check(mism == 0, f"{case.name}: {mism} pixels differ from the oracle")
        rec["plain_ms"] = cuda_ms(lambda: winding_ref.winding_banded_batch(*sargs, width=case.size),
                                  inner=1, reps=3, warmup=1)
        rec["plan"] = winding.banded_plan(b, case.strip[0].shape[1], rec["bands"], case.size)
        record[case.name] = rec
        print(f"{case.name} [{rec['card']}]: {case.glyphs} glyphs in {b} strips of "
              f"{rec['bands']} bands; 0 of {out.numel()} pixels differ from the plain version, 0 "
              f"from winding() per glyph, 0 of {len(sampled) * case.size ** 2} from the oracle "
              f"({len(sampled)} glyphs); inked {rec['ink']}; winding_banded() {rec['ms']:.4f} ms "
              f"on the device, {rec['call_ms']:.4f} ms per wrapper call, bound "
              f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}; {rec['bound_ops']} FP32 ops, "
              f"{rec['bound_bytes']} B); winding() per glyph {rec['winding_ms']:.4f} ms, "
              f"{rec['winding_call_ms']:.4f} ms per call, bound {rec['winding_bound_ms']:.5f} ms "
              f"({rec['winding_bound_by']}); strip / per glyph "
              f"{rec['ms'] / rec['winding_ms']:.3f}; plain version {rec['plain_ms']:.3f} ms; "
              f"plan {rec['plan']} (rows, chunk, cells a lane, shared bytes, list capacity), "
              f"winding() per glyph {plan_text(case.glyphs, case.size, case.size)}")
    print(f"banded phase: {time.perf_counter() - t0:.1f} s, the cases' build included")
    return record, launches["winding_banded"], max_err, build_s


def probe_edit(sess, i) -> str:
    """The probe's ``i``-th edit: every fourth a backspace, else a letter."""
    if i % 4 == 3:
        sess.backspace()
        return "backspace"
    sess.char_input("abcdefgh"[i % 8])
    return "char_input"


def edit_frame(sess, log, leg, op, relayout_ms=None, frame_fn=None):
    """A frame of an edit session, logged and returned: the page (a host
    array), its layout, view and MSAA toggle, the path it took, its band,
    the page kernels' launches in it and its time (``stats()``'s, the page
    to the host included). The band is ``_dirty_band`` of the span the
    frame consumes; the path is told from the session's cache around the
    frame: a cached or off-screen frame keeps the cached page, a band frame
    replaces it under the same view state with MSAA and debug off, any other
    frame is a full one. ``frame_fn`` takes the frame (default
    ``sess.frame``)."""
    pending, state, cached = sess._pending_dirty, sess._page_state, sess._page_dev
    band = sess._dirty_band(*pending) if pending not in ("all", ()) else None
    before = page.launches, page.msaa_launches
    frame = (frame_fn or sess.frame)()
    if sess._page_dev is cached:
        path, band = ("cached" if pending == () else "offscreen"), None
    elif (band not in (None, (0, 0)) and sess._page_state == state
          and not sess.msaa and not sess.debug):
        path = "band"
    else:
        path, band = "full", None
    log.append(dict(leg=leg, op=op, path=path, band=band,
                    launches=(page.launches - before[0], page.msaa_launches - before[1]),
                    frame_ms=sess.frame_ms[-1], relayout_ms=relayout_ms, frame=frame,
                    layout=sess.layout, view=sess.view, msaa=sess.msaa))
    return frame


def run_edit_legs(sess, legs):
    """The first frame, then each leg: its zoom with a frame (the band leg
    also drags the last line to the first line's place, with a frame), then
    its edits with a frame after each, the re-layout timed apart."""
    log = []
    edit_frame(sess, log, "first", "first")
    for leg, zoom, edits in legs:
        if zoom is not None:
            sess.scroll(*zoom)
            edit_frame(sess, log, leg, "zoom")
        if leg == "band":
            lines = sess.text.count("\n")
            lh = sess._layout_engine._line_height()
            sess.drag(0.0, lines * lh * sess.view.scale[1] * sess.view.aspect_ratio)
            edit_frame(sess, log, leg, "drag")
        for i in range(edits):
            t0 = time.perf_counter()
            op = probe_edit(sess, i)
            edit_frame(sess, log, leg, op, (time.perf_counter() - t0) * 1e3)
    return log


def probe_run(font, dev, incremental):
    """The probe's 10k-character session: two frames, the 24 edits, then 12
    zoom/pan frames, each logged; with ``incremental`` off, every edit lays
    the whole text out again (as the probe sets it). Returns the probe's
    medians with the paths of the edit frames, the log and the session."""
    sess = InteractiveSession(font, PROBE_TEXT, *CONFIG5_SIZE, dev)
    if not incremental:
        sess._layout_engine._mergeable = False
    log = []
    edit_frame(sess, log, "start", "first")
    edit_frame(sess, log, "start", "repeated")
    for i in range(EDIT_FRAMES):
        t0 = time.perf_counter()
        op = probe_edit(sess, i)
        edit_frame(sess, log, "edit", op, (time.perf_counter() - t0) * 1e3)
    for i in range(ZOOM_PAN_FRAMES):
        if i % 3 == 0:
            sess.scroll(0.5 if i % 2 else -0.5, (0.1, 0.1))
        else:
            sess.drag(0.01, 0.005)
        edit_frame(sess, log, "zoom-pan", "zoom" if i % 3 == 0 else "drag")
    edits = [f for f in log if f["leg"] == "edit"]
    result = dict(
        incremental=incremental, chars=len(sess.text),
        edit_host_relayout_ms=statistics.median(f["relayout_ms"] for f in edits),
        edit_frame_ms=statistics.median(f["frame_ms"] for f in edits),
        edit_total_ms=statistics.median(f["relayout_ms"] + f["frame_ms"] for f in edits),
        zoom_pan_ms=statistics.median(f["frame_ms"] for f in log if f["leg"] == "zoom-pan"),
        paths={p: sum(f["path"] == p for f in edits) for p in ("band", "full", "offscreen")})
    return result, log, sess


def check_edit_log(font, name, log, size, dev, fresh_legs=()):
    """Each logged frame against the plain version: the session's cache
    replayed with ``page_ref`` (a full frame its whole page, the MSAA page
    with ``m`` on, a band frame its band written into a copy of the page
    before) on every pixel, and against a fresh ``render_direct`` of its
    layout, view and toggle, which it must equal in ``fresh_legs``; the page
    kernels' launches per path. Records each frame's count against the fresh
    page."""
    w, h = size
    expect = None
    for k, f in enumerate(log):
        what = f"{name} {f['leg']} frame {k} ({f['op']}, {f['path']})"
        frame = torch.from_numpy(f["frame"]).to(dev)
        check(frame.shape == (h, w) and frame.dtype == torch.uint8, f"{what}: shape")
        renderer = PageRenderer(font, f["layout"], w, h, dev)
        inputs = renderer.page_inputs(f["view"])
        if f["path"] == "full":
            expect = (page_ref.direct_page_msaa(*inputs, page_h=h, page_w=w) if f["msaa"]
                      else page_ref.direct_page(*inputs, page_h=h, page_w=w))
        elif f["path"] == "band":
            y0, rows = f["band"]
            check(rows == InteractiveSession._BAND_H, f"{what}: a band of {rows} rows")
            expect = expect.clone()
            expect[y0:y0 + rows] = page_ref.direct_page(*inputs, y0, page_h=h, page_w=w,
                                                        out_h=rows)
        want = ((0, 1) if f["msaa"] else (1, 0)) if f["path"] in ("full", "band") else (0, 0)
        check(f["launches"] == want, f"{what}: launched (page, page_msaa) {f['launches']}")
        diff = int((frame != expect).sum())
        check(diff == 0, f"{what}: {diff} pixels differ from page_ref's spliced page")
        f["fresh_diff"] = int((frame != renderer.render_direct(f["view"], msaa=f["msaa"])).sum())
        if f["leg"] in fresh_legs:
            check(f["fresh_diff"] == 0,
                  f"{what}: {f['fresh_diff']} pixels differ from a fresh render_direct")


def edit_summary(log):
    """Per leg: its frames by path, and the medians of its edit frames'
    re-layout and frame times (ms) with their band frames' frame time."""
    out = {}
    for leg in dict.fromkeys(f["leg"] for f in log):
        frames = [f for f in log if f["leg"] == leg]
        edits = [f for f in frames if f["relayout_ms"] is not None]
        bands = [f["frame_ms"] for f in edits if f["path"] == "band"]
        out[leg] = dict(
            paths={p: sum(f["path"] == p for f in edits)
                   for p in ("band", "full", "offscreen", "cached")},
            edits=len(edits),
            relayout_ms=statistics.median(f["relayout_ms"] for f in edits) if edits else None,
            edit_frame_ms=statistics.median(f["frame_ms"] for f in edits) if edits else None,
            band_frame_ms=statistics.median(bands) if bands else None,
            fresh_diff=[f["fresh_diff"] for f in frames])
    return out


def band_timings(font, f, size, dev):
    """The band of logged frame ``f``: the page kernel on it (graph replays)
    beside the whole page at the same view, its ``render_direct(band=)``
    call, the splice (a copy of the page with the band written in; graph
    replays and calls), the plain version and the bound."""
    w, h = size
    renderer = PageRenderer(font, f["layout"], w, h, dev)
    view, (y0, rows) = f["view"], f["band"]
    inputs = renderer.page_inputs(view)
    page_dev = torch.from_numpy(f["frame"]).to(dev)
    strip = page_dev[y0:y0 + rows].clone()

    def splice():
        out = page_dev.clone()
        out[y0:y0 + rows] = strip
        return out

    ops, needed, crossings = page_work(*inputs, y0, page_h=h, page_w=w, out_h=rows)
    b_ms, bound_by = bound_ms(page_bytes(len(inputs[0]), len(inputs[2]), rows, w), ops)
    return dict(
        y0=y0, rows=rows,
        ms=graph_ms(lambda: page.direct_page(*inputs, y0, page_h=h, page_w=w, out_h=rows)),
        full_page_ms=graph_ms(lambda: page.direct_page(*inputs, page_h=h, page_w=w)),
        call_ms=cuda_ms(lambda: renderer.render_direct(view, band=(y0, rows)), inner=10),
        splice_ms=graph_ms(splice), splice_call_ms=cuda_ms(splice, inner=10),
        plain_ms=cuda_ms(lambda: page_ref.direct_page(*inputs, y0, page_h=h, page_w=w,
                                                      out_h=rows), inner=1, reps=3, warmup=1),
        bound_ms=b_ms, bound_by=bound_by, bound_ops=ops, needed_pairs=needed,
        crossings=crossings)


def full_frame_timings(font, log, size, dev):
    """Per leg, its last full single-sample frame: the page kernel on it
    (graph replays) and its bound."""
    w, h = size
    out = {}
    for leg in dict.fromkeys(f["leg"] for f in log):
        full = [f for f in log if f["leg"] == leg and f["path"] == "full" and not f["msaa"]]
        if not full:
            continue
        inputs = PageRenderer(font, full[-1]["layout"], w, h, dev).page_inputs(full[-1]["view"])
        ops, _, _ = page_work(*inputs, page_h=h, page_w=w)
        b_ms, bound_by = bound_ms(page_bytes(len(inputs[0]), len(inputs[2]), h, w), ops)
        out[leg] = dict(ms=graph_ms(lambda: page.direct_page(*inputs, page_h=h, page_w=w)),
                        bound_ms=b_ms, bound_by=bound_by, full_frames=len(full))
    return out


def edit_phase(dev, font, zoom_pan_ms):
    """The edit path: config 5's session and the narrow one through their
    legs, and the probe's 10k-character page with the incremental layout on
    and off, with the launch counts set to 0 just before and read just
    after; then every frame checked, the band kernel and the splice timed.
    ``zoom_pan_ms`` is config 5's zoom/pan frame time (its ``stats()``).
    Returns the page kernel's entry additions and its launches."""
    sess5 = InteractiveSession(font, CONFIG5_TEXT, *CONFIG5_SIZE, dev)
    sessn = InteractiveSession(font, EDIT_NARROW_TEXT, *EDIT_NARROW_SIZE, dev)
    reset_counts()
    log5 = run_edit_legs(sess5, EDIT_LEGS)
    logn = run_edit_legs(sessn, EDIT_LEGS[:3])
    probe = {key: probe_run(font, dev, key == "incremental")
             for key in ("incremental", "full_relayout")}
    torch.cuda.synchronize()
    launches = counts()
    logs = {"config5": log5, "narrow": logn,
            **{f"probe10k_{key}": run[1] for key, run in probe.items()}}
    logged = sum(f["launches"][0] for log in logs.values() for f in log)
    band_launches = sum(f["path"] == "band" for log in logs.values() for f in log)
    check(launches["page"] == logged and band_launches > 0,
          f"the edit path launched {launches}, its frames {logged}, {band_launches} bands")
    check(not any(v for k, v in launches.items() if k != "page"),
          f"the edit path launched another kernel than page(): {launches}")
    for name, log, legs in (("config5", log5, ("band",)), ("narrow", logn, ("first", "zoom-in"))):
        for leg in legs:
            n = sum(f["path"] == "band" for f in log if f["leg"] == leg)
            check(n > 0, f"{name} {leg} leg: no frame took the band path")
    print(f"edit path: {launches['page']} page kernel launches, {band_launches} of them 256-row "
          f"bands; {json.dumps(launches)}")

    check_edit_log(font, "config5", log5, CONFIG5_SIZE, dev, EDIT_FRESH_LEGS)
    check_edit_log(font, "narrow", logn, EDIT_NARROW_SIZE, dev, EDIT_FRESH_LEGS)
    for key, (result, log, sess) in probe.items():
        check_edit_log(font, f"probe10k {key}", log, CONFIG5_SIZE, dev, ("start", "edit"))
    a, b = (run[2].layout for run in probe.values())
    check(a.slot_gids == b.slot_gids and np.array_equal(a.batch.segments, b.batch.segments)
          and all(np.array_equal(x, y) for x, y in zip(a.instance_arrays(),
                                                       b.instance_arrays())),
          "probe10k: the incremental layout differs from the whole one")
    summary = {"config5": edit_summary(log5), "narrow": edit_summary(logn)}
    for name, per_leg in summary.items():
        for leg, rec in per_leg.items():
            print(f"{name} edit leg {leg}: {rec['edits']} edits, paths {json.dumps(rec['paths'])}; "
                  f"median re-layout {rec['relayout_ms']} ms, edit frame {rec['edit_frame_ms']} "
                  f"ms (band frames {rec['band_frame_ms']}); pixels differing from a fresh page "
                  f"per frame {rec['fresh_diff']}")
    print("edit path: every frame equals page_ref's spliced page; config5 and narrow equal a "
          f"fresh render_direct in the legs {EDIT_FRESH_LEGS}; probe10k's edit frames equal a "
          "fresh render_direct; its incremental layout equals the whole one")

    bands = {name: band_timings(font, [f for f in log if f["path"] == "band"][-1], size, dev)
             for name, log, size in (("config5", log5, CONFIG5_SIZE),
                                     ("narrow", logn, EDIT_NARROW_SIZE))}
    # the prediction's case: a band of config 5's first view (rows 400-655)
    first = dict(log5[0], band=PAGE_BAND)
    bands["config5_first_view"] = band_timings(font, first, CONFIG5_SIZE, dev)
    for name, t in bands.items():
        print(f"{name} band ({t['y0']}, {t['rows']}): kernel {t['ms']:.4f} ms on the device "
              f"({t['ms'] / t['full_page_ms']:.2f}x the whole page's {t['full_page_ms']:.4f}), "
              f"render_direct(band=) {t['call_ms']:.4f} ms per call, splice {t['splice_ms']:.4f} "
              f"ms on the device ({t['splice_call_ms']:.4f} per call), bound "
              f"{t['bound_ms']:.5f} ms ({t['bound_by']}), plain version {t['plain_ms']:.3f} ms")
    full = {name: full_frame_timings(font, log, size, dev)
            for name, log, size in (("config5", log5, CONFIG5_SIZE),
                                    ("narrow", logn, EDIT_NARROW_SIZE),
                                    *((f"probe10k_{key}", run[1], CONFIG5_SIZE)
                                      for key, run in probe.items()))}
    for name, per_leg in full.items():
        for leg, t in per_leg.items():
            print(f"{name} edit leg {leg}: {t['full_frames']} full frames; the last one's kernel "
                  f"{t['ms']:.4f} ms on the device, bound {t['bound_ms']:.5f} ms "
                  f"({t['bound_by']})")
    for key, (result, _, sess) in probe.items():
        print(f"probe10k {key}: {json.dumps(result)}; session stats {json.dumps(sess.stats())}")
    edit5 = [f["frame_ms"] for f in log5 if f["relayout_ms"] is not None]
    print(f"config5 edit frames: median {statistics.median(edit5):.3f} ms, mean "
          f"{statistics.fmean(edit5):.3f} ms over {len(edit5)}; zoom/pan frames (the page "
          f"path's session) mean {zoom_pan_ms:.3f} ms; session stats {json.dumps(sess5.stats())}")
    record = dict(
        launches=launches["page"], band_launches=band_launches,
        band=bands["config5"], narrow_band=bands["narrow"],
        first_view_band=bands["config5_first_view"], full_frames=full,
        config5_edit_frame_ms=statistics.median(edit5), config5_zoom_pan_ms=zoom_pan_ms,
        legs=summary, probe10k={key: run[0] for key, run in probe.items()})
    return record, launches["page"]


@contextlib.contextmanager
def patched(owner, name, make):
    """``owner.name`` replaced by ``make(original)`` while inside (a
    classmethod's original comes bound to its class)."""
    saved = vars(owner)[name]
    setattr(owner, name, make(getattr(owner, name)))
    try:
        yield
    finally:
        setattr(owner, name, saved)


@contextlib.contextmanager
def counting_plain():
    """While inside, count the calls of the plain versions that the kernels'
    wrappers run on CPU tensors: yields a one-element list."""
    count = [0]

    def make(fn):
        def call(*args, **kwargs):
            count[0] += 1
            return fn(*args, **kwargs)
        return call

    with contextlib.ExitStack() as stack:
        for module, name in PLAIN_FUNCTIONS:
            stack.enter_context(patched(module, name, make))
        yield count


class CliStages:
    """Host ms of a CLI call's stages: each wrapped function, synchronised,
    adds its time to its stage in the newest row (``rows``, one a call) and
    keeps its last call (``last``: function, arguments)."""

    # (owner, attribute, stage)
    WRAPPED = ((Font, "open", "font_open"), (cli, "layout_text", "layout"),
               (TriangulatedGlyph, "from_glyph", "layout"),
               (PageRenderer, "render_direct", "render"), (RasterEngine, "coverage_batch", "render"),
               (RasterEngine, "sdf_batch", "render"), (RasterEngine, "winding_glyph", "render"),
               (cli, "loopblinn_fill", "render"), (cli, "debug_render", "render"),
               (cli, "_rgb", "to_host"), (cli, "encode_rgb", "encode"))
    STAGES = ("font_open", "layout", "render", "to_host", "encode")

    def __init__(self):
        self.rows: list[dict] = []
        self.last: dict = {}

    def wrap(self, stage):
        def make(fn):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                row = self.rows[-1]
                row[stage] = row.get(stage, 0.0) + (time.perf_counter() - t0) * 1e3
                self.last[stage] = (fn, args, kwargs)
                return out
            return call
        return make

    @contextlib.contextmanager
    def installed(self):
        with contextlib.ExitStack() as stack:
            for owner, name, stage in self.WRAPPED:
                stack.enter_context(patched(owner, name, self.wrap(stage)))
            yield self


def live_counts(segments) -> np.ndarray:
    """Per glyph, its segments before the all-zero padding."""
    seg = np.asarray(segments, np.float32)
    return (seg.reshape(seg.shape[0], seg.shape[1], 6) != 0).any(axis=2).sum(axis=1)


def plan_text(b, h, w, win_rows=0) -> str:
    """The launch plan of ``winding()`` (``win_rows`` 0) or ``winding_windows()``
    for ``b`` glyphs of ``h`` x ``w``, from the library's ``winding_plan()``."""
    rows, chunk, cols, smem = winding.plan(b, h, w, win_rows)
    return f"plan {rows} rows a block, {chunk}-segment chunk, {cols} cells a lane, {smem} B"


def lb_plan_text(b, m, h, w) -> str:
    rows, row_bands, cols, col_bands, chunk, chunks = loopblinn.plan(b, m, h, w)
    return (f"plan: blocks of {rows} rows x {cols} columns, {row_bands} x {col_bands} a "
            f"glyph, {chunks} chunk(s) of {chunk} triangles")


def cli_kernel_ms(render):
    """The device ms (CUDA-graph replays) of the kernels that a CLI call's
    render call ``(function, arguments)`` launched, on the same inputs, and
    their bound: ``{"ms", "bound_ms", "bound_by"}``, the bounds of two
    launches added (the SDF's sign, then its distances); ``None`` for ``-d``
    (host NumPy)."""
    fn, args, kwargs = render

    def timed(kernel, *bounds):
        b_ms = sum(b for b, _ in bounds)
        by = "+".join(by for _, by in bounds)
        return dict(ms=graph_ms(kernel), bound_ms=b_ms, bound_by=by)

    if fn.__name__ == "render_direct":
        renderer, view = args
        inputs = renderer.page_inputs(view)
        h, w = renderer.height, renderer.width
        ops, _, _ = page_work(*inputs, page_h=h, page_w=w)
        return timed(lambda: page.direct_page(*inputs, page_h=h, page_w=w),
                     bound_ms(page_bytes(len(inputs[0]), len(inputs[2]), h, w, "fill"), ops))
    if fn.__name__ in ("coverage_batch", "sdf_batch", "winding_glyph"):
        if fn.__name__ == "winding_glyph":
            engine, segments, grid = args
            batch = (np.asarray(segments, np.float32)[None], [grid.min_x], [grid.max_y],
                     grid.scale)
            kwargs = dict(height=grid.height, width=grid.width)
        else:
            engine, *batch = args
        dev_args = to_device(*batch, engine.device)
        h, w = kwargs["height"], kwargs["width"]
        counts = live_counts(batch[0])
        if fn.__name__ == "coverage_batch":
            k = kwargs["samples"]
            ops, nbytes, _ = winding_work(
                batch[0], counts, dev_args[2], dev_args[3], height=h, width=w,
                row_offsets=coverage_ref.sample_offsets(k)[::k, 1], columns=k,
                samples_per_pixel=k * k)
            return timed(lambda: coverage.coverage_batch(*dev_args, **kwargs),
                         bound_ms(nbytes, ops))
        ops, nbytes, _ = winding_work(batch[0], counts, dev_args[2], dev_args[3], height=h,
                                      width=w)
        print(f"CLI winding(): {len(counts)} glyphs of {h} x {w}, "
              f"{plan_text(len(counts), h, w)}")
        if fn.__name__ == "winding_glyph":
            return timed(lambda: winding.winding_batch(*dev_args, height=h, width=w),
                         bound_ms(nbytes, ops))
        out = torch.empty((len(counts), h, w), dtype=torch.float32, device=dev_args[0].device)
        spread = kwargs.get("spread_px", sdf_ref.SPREAD_PX)
        sdf_ops, _ = sdf_work(*dev_args, height=h, width=w, spread_px=spread)
        sdf_bytes = sum(t.numel() * t.element_size() for t in (*dev_args[:3], out))
        return timed(lambda: sdf.sdf_batch(*dev_args, **kwargs), bound_ms(nbytes, ops),
                     bound_ms(sdf_bytes + out.numel() * 4, sdf_ops))
    if fn.__name__ == "loopblinn_fill":
        mesh, grid = args
        dev_args = triangles_to_device(*loopblinn.pack_meshes([mesh]), [grid], kwargs["device"])
        ops, _ = loopblinn_work(*dev_args, height=grid.height, width=grid.width)
        nbytes = loopblinn_bytes(dev_args[1], grid.height, grid.width)
        return timed(lambda: loopblinn.loopblinn_batch(*dev_args, height=grid.height,
                                                       width=grid.width),
                     bound_ms(nbytes, ops))
    return None


def cli_cold_s(argv, out) -> float:
    """Wall seconds of ``python -m fontrx_torch`` in a new process (torch's
    import and the card's set-up included; the kernels are already built)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "fontrx_torch", "-f", str(DEJAVU), *argv,
                           "-o", str(out)], cwd=ROOT, capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"python -m fontrx_torch {argv}: {proc.stderr[-2000:]}")
    return secs


def cli_interactive(tmp) -> tuple[list, str]:
    """``python -m fontrx_torch -i`` on config 5's text through
    ``CLI_SCRIPT`` from a StringIO stdin, each frame logged by
    ``edit_frame``: the log and the last line printed."""
    log = []
    frame = InteractiveSession.frame
    stdout = io.StringIO()
    with (patched(InteractiveSession, "frame", lambda _: lambda sess: edit_frame(
              sess, log, "cli", "frame", frame_fn=lambda: frame(sess))),
          patched(sys, "stdin", lambda _: io.StringIO("\n".join(CLI_SCRIPT) + "\n")),
          contextlib.redirect_stdout(stdout)):
        check(cli.main(["-f", str(DEJAVU), "-t", CONFIG5_TEXT, "-i", "-o",
                        str(tmp / "frame.qoi")]) == 0, "the -i loop failed")
    return log, stdout.getvalue().strip().splitlines()[-1]


def cli_phase(dev, tmp):
    """The command line in process, as a user calls it (``cli.main``, the
    card by default): each case of ``CLI_CASES`` once and ``CLI_WARM`` times
    warm, then the ``-i`` loop, with the launch counts set to 0 just before
    and read just after, and no plain version may run. Then each image is
    held to the same argv with ``--backend cpu`` (equal QOI bytes), config
    1's page to the oracle, the loop's frames to the plain version; the
    values a standard QOI decoder reads wrong are counted, the kernels are
    timed, and ``CLI_COLD`` also in a new process. Returns the record and
    the launches by kernel."""
    stages = CliStages()
    runs = {}
    reset_counts()
    with counting_plain() as plain:
        with stages.installed():
            for name, argv, want in CLI_CASES:
                before = counts()
                calls_ms = []
                for _ in range(1 + CLI_WARM):
                    stages.rows.append({})
                    t0 = time.perf_counter()
                    check(cli.main(["-f", str(DEJAVU), *argv, "-o", str(tmp / f"{name}.qoi")])
                          == 0, f"CLI {name} failed")
                    calls_ms.append((time.perf_counter() - t0) * 1e3)
                launched = {k: v - before[k] for k, v in counts().items() if v != before[k]}
                check(launched == {k: n * (1 + CLI_WARM) for k, n in want.items()},
                      f"CLI {name}: {1 + CLI_WARM} calls launched {launched}, not {want} each")
                runs[name] = dict(first_ms=calls_ms[0], warm_ms=statistics.median(calls_ms[1:]),
                                  split={stage: statistics.median(
                                      row.get(stage, 0.0) for row in stages.rows[-CLI_WARM:])
                                      for stage in CliStages.STAGES},
                                  render=stages.last["render"])
        before = counts()
        log, stats_line = cli_interactive(tmp)
        i_launches = {k: v - before[k] for k, v in counts().items() if v != before[k]}
    torch.cuda.synchronize()
    launches = counts()
    check(plain[0] == 0, f"the CLI ran a plain version {plain[0]} times on the card")
    check(i_launches == {"page": 3, "page_msaa": 1},
          f"the -i loop launched {i_launches}, not page() 3 and page_msaa() 1")
    print(f"CLI: {json.dumps(launches)} launches, 0 plain-version runs")

    record = {}
    for name, argv, _ in CLI_CASES:
        run = runs[name]
        data = (tmp / f"{name}.qoi").read_bytes()
        t0 = time.perf_counter()
        check(cli.main(["-f", str(DEJAVU), *argv, "--backend", "cpu", "-o",
                        str(tmp / f"{name}_cpu.qoi")]) == 0, f"CLI {name} --backend cpu failed")
        cpu_ms = (time.perf_counter() - t0) * 1e3
        got, want = qoi.decode(data), qoi.decode((tmp / f"{name}_cpu.qoi").read_bytes())
        check(got.shape == want.shape, f"CLI {name}: shape {got.shape}, on the CPU {want.shape}")
        steps = int(np.abs(got.astype(np.int16) - want).max())
        check(data == (tmp / f"{name}_cpu.qoi").read_bytes(),
              f"CLI {name}: its QOI differs from --backend cpu's ({steps} u8 steps)")
        # what a standard viewer reads wrong (encode_rgb's index-slot fault)
        misread = int((qoi.decode(data, strict=True) != got).sum())
        if name == "config1":
            renderer, view = run["render"][1]
            q = page_ref.transform_segments(*renderer.page_inputs(view)).cpu().numpy()
            h, w = renderer.height, renderer.width
            ink = oracle.winding_at(q, np.arange(w, dtype=np.float32)[None, :],
                                    (h - 1 - np.arange(h)).astype(np.float32)[:, None],
                                    contract=False) != 0
            check(np.array_equal(got[..., 0], np.where(ink, 255, 0)) and (got == got[..., :1]).all(),
                  "config 1's page differs from the oracle fill")
            print(f"CLI config1: the {h} x {w} page equals the oracle's fill on its samples "
                  f"({int(ink.sum())} ink pixels)")
        run.update(shape=list(got.shape), spec_decoder_misreads=misread, cpu_call_ms=cpu_ms,
                   kernel_ms=cli_kernel_ms(run.pop("render")))
        if name == CLI_COLD:
            run["cold_s"] = cli_cold_s(argv, tmp / f"{name}_cold.qoi")
            check((tmp / f"{name}_cold.qoi").read_bytes() == data,
                  f"CLI {name}: the new process's image differs from the in-process one")
        record[name] = run
        print(f"CLI {name} ({' '.join(argv)}): {got.shape[1]} x {got.shape[0]}; first call "
              f"{run['first_ms']:.2f} ms, warm median {run['warm_ms']:.2f} ms = "
              + ", ".join(f"{k} {v:.3f}" for k, v in run["split"].items())
              + (f" ms; kernel {run['kernel_ms']['ms']:.4f} ms on the device, bound "
                 f"{run['kernel_ms']['bound_ms']:.5f} ms ({run['kernel_ms']['bound_by']})"
                 if run["kernel_ms"] else " ms; no kernel")
              + (f"; new process {run['cold_s']:.2f} s" if "cold_s" in run else "")
              + f"; QOI bytes equal to --backend cpu's ({cpu_ms:.1f} ms on the CPU); "
              f"a standard QOI decoder misreads {misread} values")

    check_edit_log(Font.open(DEJAVU), "cli -i", log, CONFIG5_SIZE, dev)
    check([f["launches"] for f in log] == [(1, 0), (1, 0), (0, 1), (1, 0)],
          f"-i frames launched {[f['launches'] for f in log]}")
    kernels = []  # each -i frame's page kernel on its inputs, beside its bound
    w, h = CONFIG5_SIZE
    for f in log:
        inputs = PageRenderer(Font.open(DEJAVU), f["layout"], w, h, dev).page_inputs(f["view"])
        if f["msaa"]:
            ops, _, _ = page_msaa_work(*inputs, page_h=h, page_w=w)
            b_ms, bound_by = bound_ms(page_msaa_bytes(len(inputs[0]), len(inputs[2]), h, w), ops)
            ms = graph_ms(lambda inputs=inputs: page.direct_page_msaa(*inputs, page_h=h,
                                                                      page_w=w))
        else:
            ops, _, _ = page_work(*inputs, page_h=h, page_w=w)
            b_ms, bound_by = bound_ms(page_bytes(len(inputs[0]), len(inputs[2]), h, w), ops)
            ms = graph_ms(lambda inputs=inputs: page.direct_page(*inputs, page_h=h, page_w=w))
        kernels.append(dict(kernel="page_msaa" if f["msaa"] else "page", ms=ms, bound_ms=b_ms,
                            bound_by=bound_by))
    misreads = []
    for n, f in enumerate(log):
        data = (tmp / f"frame_{n:04d}.qoi").read_bytes()
        rgb = qoi.decode(data)
        check(np.array_equal(rgb, np.repeat(f["frame"][:, :, None], 3, axis=2)),
              f"-i frame {n}: its QOI differs from the page")
        misreads.append(int((qoi.decode(data, strict=True) != rgb).sum()))
    stats = ast.literal_eval(stats_line)
    check(stats["frames"] == len(log), f"-i stats: {stats_line}")
    record["interactive"] = dict(launches=i_launches, frame_ms=[f["frame_ms"] for f in log],
                                 kernels=kernels, spec_decoder_misreads=misreads, stats=stats)
    print(f"CLI -i: {len(log)} frames of config 5 equal the plain version (MSAA after m), "
          f"launches {json.dumps(i_launches)}, frame ms {record['interactive']['frame_ms']}, "
          f"kernels " + ", ".join(f"{k['kernel']} {k['ms']:.4f} ms (bound {k['bound_ms']:.5f})"
                                  for k in kernels) + "; "
          f"values a standard QOI decoder misreads {misreads}; {stats_line}")
    return record, launches


def gate10_tiles(font, chars, size: int) -> np.ndarray:
    """Gate 10's NumPy recipe (``benchmarks/full_gate.py:514-570``) for the
    colour tiles of ``chars`` at ``size`` px in palette 0: per layer, the
    oracle's 2 x 2 coverage on the glyph's tile, ``a = cov * f32(a / 255)``,
    ``src = (f32(c) / f32(255) * a, a)``, folded ``dst * (1 - a) + src``."""
    out = np.zeros((len(chars), size, size, 4), np.float32)
    c255 = np.float32(255.0)
    for i, ch in enumerate(chars):
        tree = font.color_paint_tree(font.glyph_index(ch))
        layers = [(font.load_glyph_safe(node[1]), node[2][1]) for node in tree[1]]
        boxes = [g.box for g, _ in layers]
        union = (min(b.x_min for b in boxes), min(b.y_min for b in boxes),
                 max(b.x_max for b in boxes), max(b.y_max for b in boxes))
        grid = RasterGrid.fixed_tile(union, size, font.info.units_per_em, size)
        for g, (r8, g8, b8, a8) in layers:
            a = coverage_oracle(glyph_segments(g), grid, 2) * np.float32(a8 / 255.0)
            src = np.stack([np.float32(r8) / c255 * a, np.float32(g8) / c255 * a,
                            np.float32(b8) / c255 * a, a], axis=-1)
            out[i] = out[i] * (np.float32(1.0) - a[..., None]) + src
    return out


def color_phase(dev, tmp):
    """The colour path as a user calls it, with the launch counts set to 0
    just before and read just after, and no plain version may run: each
    case of ``COLOR_CLI`` once and ``COLOR_WARM`` times warm (one coverage
    launch a call), then the sessions of ``COLOR_SESSIONS`` (one coverage
    launch a zoom). Then each CLI file is held to ``--backend cpu``'s bytes,
    the tiles of A, B and C at 64 px to gate 10's oracle, each session's
    tiles at each zoom to the plain version's, and each frame to the plain
    composite of the plain tiles; the tile pass (coverage kernel and fold),
    the kernel alone and the composite are timed. Returns the record and the
    coverage kernel's launches."""
    sessions = {}
    cli_ms = {}
    reset_counts()
    with counting_plain() as plain:
        for name, argv in COLOR_CLI:
            before = coverage.launches
            calls = []
            for _ in range(1 + COLOR_WARM):
                t0 = time.perf_counter()
                check(cli.main([*argv, "-o", str(tmp / f"{name}.qoi")]) == 0,
                      f"CLI {name} failed")
                calls.append((time.perf_counter() - t0) * 1e3)
            check(coverage.launches - before == 1 + COLOR_WARM,
                  f"CLI {name}: {coverage.launches - before} coverage launches in "
                  f"{1 + COLOR_WARM} calls")
            cli_ms[name] = dict(first_ms=calls[0], warm_ms=statistics.median(calls[1:]))
        for name, font_path, text, events in COLOR_SESSIONS:
            before = coverage.launches
            sess = InteractiveSession(Font.open(font_path), text, *CONFIG5_SIZE, dev,
                                      mode="color")
            frames, views = run_events(sess, events)
            # the tiles raster again where a frame's zoom is not the last one's
            zooms = 1 + sum(a.scale[0] != b.scale[0] for a, b in zip(views, views[1:]))
            check(coverage.launches - before == zooms,
                  f"{name} colour session: {coverage.launches - before} coverage launches, "
                  f"not one for each of its {zooms} changes of zoom")
            sessions[name] = (sess, frames, views)
    torch.cuda.synchronize()
    launches = counts()
    check(plain[0] == 0, f"the colour path ran a plain version {plain[0]} times on the card")
    check(launches == {**{k: 0 for k in launches}, "coverage": launches["coverage"]},
          f"the colour path launched {launches}")
    print(f"colour path: {launches['coverage']} coverage kernel launches, nothing else, "
          "0 plain-version runs")

    record = {"cli": {}, "sessions": {}}
    for name, argv in COLOR_CLI:
        data = (tmp / f"{name}.qoi").read_bytes()
        check(cli.main([*argv, "--backend", "cpu", "-o", str(tmp / f"{name}_cpu.qoi")]) == 0,
              f"CLI {name} --backend cpu failed")
        check(data == (tmp / f"{name}_cpu.qoi").read_bytes(),
              f"CLI {name}: its QOI differs from --backend cpu's")
        got = qoi.decode(data)
        misread = int((qoi.decode(data, strict=True) != got).sum())
        stages = CliStages()
        stages.rows.append({})
        with stages.installed():
            cli.main([*argv, "-o", str(tmp / f"{name}_timed.qoi")])
        record["cli"][name] = dict(**cli_ms[name], shape=list(got.shape),
                                   spec_decoder_misreads=misread,
                                   kernel_ms=cli_kernel_ms(stages.last["render"]))
        k = record["cli"][name]["kernel_ms"]
        print(f"CLI {name}: {got.shape[1]} x {got.shape[0]}, QOI bytes equal to --backend "
              f"cpu's; first call {cli_ms[name]['first_ms']:.2f} ms, warm median "
              f"{cli_ms[name]['warm_ms']:.2f} ms; coverage kernel {k['ms']:.4f} ms, bound "
              f"{k['bound_ms']:.5f} ms ({k['bound_by']}); a standard QOI decoder misreads "
              f"{misread} values")

    cfont = Font.open(COLRTEST)
    tiles, _ = colorglyphs.color_glyph_tiles(cfont, [cfont.glyph_index(c) for c in "ABC"], 64,
                                             RasterEngine(dev))
    want = gate10_tiles(cfont, "ABC", 64)
    mismatch = int((tiles.cpu().numpy() != want).sum())
    check(mismatch == 0, f"colour tiles at 64 px: {mismatch} values differ from gate 10's oracle")
    record["gate10_tiles"] = dict(checked=int(want.size), mismatch=mismatch)
    print(f"colour tiles of A, B and C at 64 px equal gate 10's NumPy oracle: 0 of {want.size} "
          "values differ")

    max_err = 0.0
    for name, (sess, frames, views) in sessions.items():
        renderer = sess.renderer
        h, w = renderer.height, renderer.width
        plain_tiles, zoom_ms = {}, {}
        for n, (frame, view) in enumerate(zip(frames, views)):
            key = view.scale[0]
            if key not in plain_tiles:
                plain_tiles[key] = renderer.color_tiles(view, plain=True)
                tiles, grids, ink = renderer.color_tiles(view)
                max_err = max(max_err, float((tiles - plain_tiles[key][0]).abs().max()))
                check(torch.equal(tiles, plain_tiles[key][0]),
                      f"{name} colour session, frame {n}: its tiles differ from the plain "
                      "version's")
            tiles, grids, _ = plain_tiles[key]
            want = colorglyphs.composite_color_page(tiles, grids, *renderer.color_pen(view),
                                                    page_h=h, page_w=w, plain=True)
            check(np.array_equal(frame, want),
                  f"{name} colour session, frame {n}: {int((frame != want).sum())} values "
                  "differ from the plain version's")
        # timings at the first view and at the last (all instances on the page)
        timed = {}
        for which, view in (("first", views[0]), ("last", views[-1])):
            tiles, grids, ink = renderer.color_tiles(view)
            slots, pen = renderer.color_pen(view)
            px_per_unit = view.scale[0] * (w / 2.0)
            gids = [int(g) for g in renderer.layout.slot_gids]
            engine = RasterEngine(dev)
            stages = CliStages()
            stages.rows.append({})
            with patched(RasterEngine, "coverage_batch", stages.wrap("render")):
                colorglyphs.color_glyph_tiles(renderer.font, gids, px_per_unit *
                                              renderer.font.info.units_per_em, engine,
                                              tile=tiles.shape[1])
            x0, y0 = colorglyphs.tile_origins(grids, slots, pen, tiles.shape[1], h, w)
            box = ink[slots]
            left, top = x0 - tiles.shape[1], y0 - tiles.shape[1]
            timed[which] = dict(
                tile=int(tiles.shape[1]), tiles=len(gids),
                on_page=int(((left + box[:, 3] > 0) & (left + box[:, 2] < w)
                             & (top + box[:, 1] > 0) & (top + box[:, 0] < h)).sum()),
                tile_pass_ms=synced_ms(lambda: colorglyphs.color_glyph_tiles(
                    renderer.font, gids, px_per_unit * renderer.font.info.units_per_em, engine,
                    tile=tiles.shape[1])),
                kernel_ms=cli_kernel_ms(stages.last["render"]),
                composite_ms=synced_ms(lambda: colorglyphs.composite_color_page(
                    tiles, grids, slots, pen, page_h=h, page_w=w, ink=ink)),
                composite_plain_ms=synced_ms(lambda: colorglyphs.composite_color_page(
                    tiles, grids, slots, pen, page_h=h, page_w=w, plain=True), reps=1))
        stats = sess.stats()
        record["sessions"][name] = dict(frames=len(frames),
                                        instances=len(renderer.layout.instances),
                                        zooms=len(plain_tiles), stats=stats, **timed)
        print(f"{name} colour session: {len(frames)} frames of {w} x {h}, "
              f"{len(renderer.layout.instances)} instances, {len(plain_tiles)} zooms, every "
              f"frame and tile pass equal to the plain version's; frame {stats['mean_ms']:.2f} "
              f"ms (p99 {stats['p99_ms']:.2f}); "
              + "; ".join(f"{which} view: {t['tiles']} tiles of {t['tile']} px, tile pass "
                          f"{t['tile_pass_ms']:.3f} ms (coverage kernel {t['kernel_ms']['ms']:.4f} "
                          f"ms, bound {t['kernel_ms']['bound_ms']:.5f} ms "
                          f"{t['kernel_ms']['bound_by']}), composite of {t['on_page']} inked "
                          f"instances {t['composite_ms']:.3f} ms, plain serial fold "
                          f"{t['composite_plain_ms']:.3f} ms" for which, t in timed.items()))
    return record, launches["coverage"], max_err


def main() -> None:
    dev = require_cuda()
    print("toolchain:", json.dumps(probe()))
    build_kernels()

    atlases, pack_s = {}, {}
    for name, font_path, chars, size in ATLASES:
        batch, grids, pack_s[name] = load_atlas(font_path, chars, size)
        atlases[name] = (batch, grids, size)
        print(f"{name}: segments {list(batch.segments.shape)}, host pack "
              f"(font parse + {len(chars)} glyphs, Python path) {pack_s[name]:.3f} s")

    engine = RasterEngine(device=dev)

    # --- winding fill path, once, through the user-facing entry points ----
    reset_counts()
    outputs = {}
    for name, (batch, grids, size) in atlases.items():
        before = winding.launches
        outputs[name] = engine.winding_batch(
            batch.segments, *grid_anchors(grids), height=size, width=size)
        torch.cuda.synchronize()
        check(winding.launches > before, f"{name} did not launch the winding kernel")

    font = Font.open(DEJAVU)
    glyph, _advance = font.get_glyph("A")
    packed = pack_glyph(glyph)
    grid = RasterGrid.for_glyph_box(packed.box, 256, font.info.units_per_em)
    before = winding.launches
    fill = engine.fill(engine.winding_glyph(packed.segments, grid)).cpu().numpy()
    rgb = np.repeat(fill[:, :, None], 3, axis=2)
    decoded = qoi.decode(qoi.encode_rgb(rgb))
    check(winding.launches > before, "quick start did not launch the winding kernel")

    before = winding.launches
    fn, example_args = entry()
    mask = fn(*example_args)
    torch.cuda.synchronize()
    check(winding.launches > before, "entry() did not launch the winding kernel")
    winding_launches = winding.launches
    print(f"winding path: {winding_launches} winding kernel launches, "
          f"{coverage.launches} coverage")

    # --- window-packed atlas path (K3), once ----------------------------------
    cjk_batch = atlases["cjk64"][0]
    cjk_upem = Font.open(CJK).info.units_per_em
    synth = np.stack([xsort_segments(s) for s in make_batch(SYNTH_GLYPHS, SYNTH_SEGMENTS)])
    win_batches = {}
    for size in WINDOW_SIZES:
        grids = [RasterGrid.fixed_tile(tuple(box), size, cjk_upem, size)
                 for box in np.asarray(cjk_batch.boxes)]
        win_batches[f"cjk{size}"] = (cjk_batch.segments, *grid_anchors(grids), size)
        win_batches[f"synth{size}"] = (
            synth, np.zeros(SYNTH_GLYPHS, np.int32), np.full(SYNTH_GLYPHS, size - 1, np.int32),
            float(np.float32(size / UPEM)), size)
    windows = {}
    for name, (segs, min_x, max_y, scale, size) in win_batches.items():
        t0 = time.perf_counter()
        windows[name] = engine.pack_windows(segs, min_x, max_y, scale, height=size)
        torch.cuda.synchronize()
        pack_s[f"{name}_windows"] = time.perf_counter() - t0
        check(windows[name] is not None, f"{name}: pack_windows packed nothing")
    reset_counts()
    win_outputs = {}
    for name, (segs, min_x, max_y, scale, size) in win_batches.items():
        win_outputs[name] = engine.winding_batch(segs, min_x, max_y, scale, height=size,
                                                 width=size, windows=windows[name])
    torch.cuda.synchronize()
    windows_launches = winding.windows_launches
    check(windows_launches == len(win_batches),
          f"the windowed path launched winding_windows() {windows_launches} times")
    check(winding.launches == 0, "the windowed path launched winding()")
    print(f"windowed path: {windows_launches} winding_windows() launches, {winding.launches} "
          "winding(); host pack_windows (to the card included): "
          + ", ".join(f"{name} {pack_s[f'{name}_windows']:.3f} s" for name in win_batches))

    # --- tile coverage path, once ------------------------------------------
    reset_counts()
    cov_outputs = {}
    for name, (batch, grids, size) in atlases.items():
        before = coverage.launches
        cov = engine.coverage_batch(batch.segments, *grid_anchors(grids), height=size,
                                    width=size, samples=SAMPLES)
        cov_outputs[name] = (cov, engine.coverage_to_gray(cov))
        torch.cuda.synchronize()
        check(coverage.launches > before, f"{name} did not launch the coverage kernel")
    coverage_launches = coverage.launches
    print(f"coverage path: {coverage_launches} coverage kernel launches, "
          f"{winding.launches} winding")

    # --- SDF atlas path, once -------------------------------------------------
    fonts = {name: font_path for name, font_path, _, _ in ATLASES}
    sdf_atlases = {}
    for name, source, size in SDF_ATLASES:
        batch = atlases[source][0]
        upem = Font.open(fonts[source]).info.units_per_em
        grids = [RasterGrid.fixed_tile(tuple(box), size, upem, size)
                 for box in np.asarray(batch.boxes)]
        sdf_atlases[name] = (batch, grids, size)
    reset_counts()
    sdf_outputs = {}
    for name, (batch, grids, size) in sdf_atlases.items():
        before = sdf.launches
        out = engine.sdf_batch(batch.segments, *grid_anchors(grids), height=size, width=size)
        sdf_outputs[name] = (out, engine.sdf_to_u8(out))
        torch.cuda.synchronize()
        check(sdf.launches > before, f"{name} did not launch the SDF kernel")
    sdf_launches, sdf_winding_launches = sdf.launches, winding.launches
    print(f"SDF path: {sdf_launches} SDF kernel launches, {sdf_winding_launches} winding, "
          f"{coverage.launches} coverage")

    # --- Loop-Blinn atlas path (BASELINE config 3), once ----------------------
    lb_tris, lb_classes, lb_grids, pack_s["ascii128_meshes"] = load_meshes(
        DEJAVU, LB_CHARS, LB_SIZE)
    print(f"ascii128: triangles {list(lb_tris.shape)} "
          f"({int((lb_classes != loopblinn_ref.CLASS_PAD).sum())} live), host "
          f"triangulation and padding {pack_s['ascii128_meshes']:.3f} s")
    lb_args = triangles_to_device(lb_tris, lb_classes, lb_grids, dev)
    g_mesh = TriangulatedGlyph.from_glyph(font.get_glyph("g")[0])
    g_grid = RasterGrid.for_glyph_box(pack_glyph(font.get_glyph("g")[0]).box, LB_SIZE,
                                      font.info.units_per_em)
    reset_counts()
    lb_out = loopblinn.loopblinn_batch(*lb_args, height=LB_SIZE, width=LB_SIZE)
    torch.cuda.synchronize()
    check(loopblinn.launches == 1, "the Loop-Blinn atlas did not launch the kernel once")
    g_fill = loopblinn.loopblinn_fill(g_mesh, g_grid)
    check(loopblinn.launches == 2, "loopblinn_fill did not launch the kernel")
    lb_launches = loopblinn.launches
    print(f"Loop-Blinn path: {lb_launches} Loop-Blinn kernel launches, "
          f"{winding.launches} winding, {coverage.launches} coverage, {sdf.launches} SDF")

    # --- direct page path (BASELINE config 5's session, the 4K stress page) --
    upem = font.info.units_per_em
    views4k = stress_views(upem)
    sess5, pack_s["config5_layout"] = open_session(font, CONFIG5_TEXT, CONFIG5_SIZE, dev)
    page4k, pack_s["page4k_layout"] = load_page(font, STRESS_TEXT, STRESS_SIZE, views4k[0], dev)
    reset_counts()
    frames5, views5 = run_events(sess5, CONFIG5_EVENTS)
    stats5 = sess5.stats()  # config 5's frames as the user sees them
    band5 = sess5.renderer.render_direct(views5[0], band=PAGE_BAND)
    sess5.key("d")
    gray5 = sess5.display_frame()      # the debug gray at the last view, opaque
    sess5.key("d")
    sess5.key("t")
    clear5 = sess5.display_frame()     # the fill again, transparent
    frames4k = [page4k.render_direct(view) for view in views4k]
    torch.cuda.synchronize()
    page_launches = page.launches
    check(page_launches == len(views5) + 3 + len(views4k),
          f"the page path launched the page kernel {page_launches} times")
    check(page.msaa_launches == 0 and winding.launches == 0,
          "the page path launched the MSAA or the winding kernel")
    print(f"page path: {page_launches} page kernel launches ({len(views5)} config5 session "
          f"frames, a band, the d and t frames, {len(views4k)} 4K frames), {winding.launches} "
          f"winding, {page.msaa_launches} MSAA; host layout and compaction: config5 "
          f"{pack_s['config5_layout']:.3f} s, page4k {pack_s['page4k_layout']:.3f} s; "
          f"config5 session stats {json.dumps(stats5)}")

    # --- page MSAA path (the session's m key, the 4K stress page) -----------
    sess5m, _ = open_session(font, CONFIG5_TEXT, CONFIG5_SIZE, dev)
    sessn, pack_s["narrow_layout"] = open_session(font, NARROW_TEXT, NARROW_SIZE, dev)
    reset_counts()
    sess5m.key("m")
    msaa5, views5m = run_events(sess5m, CONFIG5_EVENTS)
    sessn.key("m")
    msaan, viewsn = run_events(sessn, NARROW_EVENTS)
    msaa4k = [page4k.render_direct(view, msaa=True) for view in views4k]
    torch.cuda.synchronize()
    msaa_launches = page.msaa_launches
    check(msaa_launches == len(views5m) + len(viewsn) + len(views4k),
          f"the MSAA path launched the MSAA kernel {msaa_launches} times")
    check(page.launches == 0 and winding.launches == 0,
          "the MSAA path launched the single-sample page kernel or the winding kernel")
    check(views5m == views5, "the MSAA session's views differ from config 5's")
    stats5m, statsn = sess5m.stats(), sessn.stats()
    print(f"MSAA path: {msaa_launches} MSAA kernel launches ({len(views5m)} config5 session "
          f"frames, {len(viewsn)} narrow session frames, {len(views4k)} 4K frames), "
          f"{page.launches} single-sample page, {winding.launches} winding; config5 session "
          f"stats {json.dumps(stats5m)}; narrow session stats {json.dumps(statsn)}")

    # --- checks ------------------------------------------------------------
    record = {"winding": {}, "coverage": {}, "sdf": {}, "loopblinn": {}, "page": {},
              "page_msaa": {}, "winding_windows": {}}
    max_err = {"winding": 0, "coverage": 0.0, "sdf": 0.0, "loopblinn": 0, "page": 0,
               "page_msaa": 0, "winding_windows": 0}
    for name, (batch, grids, size) in atlases.items():
        args = packed_to_device(batch, grids, dev)
        b = len(grids)
        out = outputs[name]
        ref = winding_ref.winding_batch(*args, height=size, width=size)
        check(out.shape == ref.shape == (b, size, size), f"{name} winding shape")
        diff = int((out != ref).sum())
        max_err["winding"] = max(max_err["winding"], int((out - ref).abs().max()))
        check(diff == 0, f"{name}: {diff} pixels differ from winding_ref")

        out_host = out.cpu().numpy()
        sampled = range(0, b, ORACLE_STRIDE)
        mism = 0
        for i in sampled:
            xs, ys = grids[i].sample_coords()
            wo = oracle.winding_at(batch.segments[i], xs[None, :], ys[:, None],
                                   contract=False)
            mism += int((wo != out_host[i]).sum())
        check(mism == 0, f"{name}: {mism} pixels differ from the oracle")
        print(f"{name} winding: 0 of {out.numel()} pixels differ from winding_ref; "
              f"0 of {len(sampled) * size * size} differ from the oracle "
              f"({len(sampled)} glyphs); inked {int((out != 0).sum())}")

        cov, gray = cov_outputs[name]
        cref = coverage_ref.coverage_batch(*args, height=size, width=size, samples=SAMPLES)
        check(cov.shape == cref.shape == (b, size, size) and cov.dtype == torch.float32,
              f"{name} coverage shape")
        check(bool(torch.isfinite(cov).all()) and float(cov.min()) >= 0
              and float(cov.max()) <= 1, f"{name} coverage outside [0, 1]")
        diff = int((cov != cref).sum())
        max_err["coverage"] = max(max_err["coverage"], float((cov - cref).abs().max()))
        check(diff == 0, f"{name}: {diff} coverage pixels differ from coverage_ref")
        check(torch.equal(gray, coverage_ref.coverage_to_gray(cref)), f"{name} gray")
        cov_host = cov.cpu().numpy()
        sampled = range(0, b, COVERAGE_ORACLE_STRIDE)
        mism = sum(int((coverage_oracle(batch.segments[i], grids[i], SAMPLES)
                        != cov_host[i]).sum()) for i in sampled)
        check(mism == 0, f"{name}: {mism} coverage pixels differ from the oracle")
        print(f"{name} coverage k={SAMPLES}: 0 of {cov.numel()} pixels differ from "
              f"coverage_ref; 0 of {len(sampled) * size * size} differ from the oracle "
              f"({len(sampled)} glyphs); partial pixels "
              f"{int(((cov > 0) & (cov < 1)).sum())}")

        kernels = {
            "winding": (
                lambda: winding.winding_batch(*args, height=size, width=size),
                lambda: winding_ref.winding_batch(*args, height=size, width=size),
                winding_work(batch.segments, batch.seg_counts, args[2], args[3], height=size,
                             width=size),
            ),
            "coverage": (
                lambda: coverage.coverage_batch(*args, height=size, width=size,
                                                samples=SAMPLES),
                lambda: coverage_ref.coverage_batch(*args, height=size, width=size,
                                                    samples=SAMPLES),
                # the k sub-row offsets; ox varies fastest in sample_offsets
                winding_work(batch.segments, batch.seg_counts, args[2], args[3], height=size,
                             width=size,
                             row_offsets=coverage_ref.sample_offsets(SAMPLES)[::SAMPLES, 1],
                             columns=SAMPLES, samples_per_pixel=SAMPLES * SAMPLES),
            ),
        }
        for kname, (kernel, plain, (ops, nbytes, crossings)) in kernels.items():
            b_ms, bound_by = bound_ms(nbytes, ops)
            call_ms = cuda_ms(kernel, inner=10)
            call_host_ms = host_ms(kernel)
            kernel_ms = graph_ms(kernel)
            plain_ms = cuda_ms(plain, inner=1)
            record[kname][name] = dict(ms=kernel_ms, plain_ms=plain_ms, call_ms=call_ms,
                                       call_host_ms=call_host_ms, bound_ms=b_ms,
                                       bound_by=bound_by, bound_ops=ops, crossings=crossings)
            print(f"{name} {kname}: kernel {kernel_ms:.4f} ms on the device "
                  f"({b / kernel_ms * 1e3:.0f} glyphs/s), {call_ms:.4f} ms per wrapper "
                  f"call ({call_host_ms:.4f} ms of it on the host); bound {b_ms:.4f} ms "
                  f"({bound_by}; {ops} FP32 ops, {crossings} crossings); plain version "
                  f"{plain_ms:.3f} ms ({b / plain_ms * 1e3:.0f} glyphs/s)"
                  + (f"; {plan_text(b, size, size)}" if kname == "winding" else ""))

    for name, (segs, min_x, max_y, scale, size) in win_batches.items():
        wins, out = windows[name], win_outputs[name]
        b = len(segs)
        seg_d, min_x_d, max_y_d, scale = to_device(segs, min_x, max_y, scale, dev)
        wargs = (wins.segments_win, wins.counts, min_x_d, max_y_d, scale)
        wkw = dict(height=size, width=size, win_rows=wins.win_rows)
        ref = winding_ref.winding_windows_batch(*wargs, **wkw)
        check(out.shape == ref.shape == (b, size, size) and out.dtype == torch.int32,
              f"{name} windowed shape")
        diff = int((out != ref).sum())
        max_err["winding_windows"] = max(max_err["winding_windows"],
                                         int((out - ref).abs().max()))
        check(diff == 0, f"{name}: {diff} pixels differ from the plain windowed version")
        full = winding.winding_batch(seg_d, min_x_d, max_y_d, scale, height=size, width=size)
        diff = int((out != full).sum())
        check(diff == 0, f"{name}: {diff} pixels differ from winding.cu")
        out_host = out.cpu().numpy()
        sampled = range(0, b, WINDOW_ORACLE_STRIDE)
        mism = 0
        for i in sampled:
            xs = (min_x[i] + np.arange(size)).astype(np.float32) / np.float32(scale)
            ys = (max_y[i] - np.arange(size)).astype(np.float32) / np.float32(scale)
            wo = oracle.winding_at(segs[i], xs[None, :], ys[:, None], contract=False)
            mism += int((wo != out_host[i]).sum())
        check(mism == 0, f"{name}: {mism} windowed pixels differ from the oracle")

        counts = wins.counts.cpu().numpy()
        rows = [min(wins.win_rows, size - w * wins.win_rows) for w in range(wins.n_windows)]
        pairs = int((counts * np.array(rows)).sum())
        live = int((np.asarray(segs) != 0).any(axis=(2, 3)).sum())
        nbytes = window_bytes(counts, size, size)
        ops, crossings = window_work(wins.segments_win.cpu().numpy(), counts, max_y, scale,
                                     **wkw)
        b_ms, bound_by = bound_ms(nbytes, ops)

        def kernel():
            return winding.winding_windows_batch(*wargs, **wkw)

        kernel_ms = graph_ms(kernel)
        call_ms = cuda_ms(kernel, inner=10)
        engine_ms = cuda_ms(lambda: engine.winding_batch(
            segs, min_x, max_y, scale, height=size, width=size, windows=wins), inner=10)
        full_ms = graph_ms(lambda: winding.winding_batch(seg_d, min_x_d, max_y_d, scale,
                                                         height=size, width=size))
        plain_ms = cuda_ms(lambda: winding_ref.winding_windows_batch(*wargs, **wkw), inner=1,
                           reps=5, warmup=1)
        record["winding_windows"][name] = dict(
            ms=kernel_ms, plain_ms=plain_ms, call_ms=call_ms, engine_call_ms=engine_ms,
            bound_ms=b_ms, bound_by=bound_by, bound_bytes=nbytes, bound_ops=ops,
            crossings=crossings, win_rows=wins.win_rows, n_windows=wins.n_windows, cap=wins.cap,
            copies=int(counts.sum()), live_segments=live, pairs=pairs,
            winding_cu_pairs=live * size, winding_cu_ms=full_ms,
            host_pack_windows_s=pack_s[f"{name}_windows"])
        print(f"{name} windowed {size}x{size} ({wins.win_rows}-row windows, cap {wins.cap}): 0 "
              f"of {out.numel()} pixels differ from the plain version and from winding.cu; 0 of "
              f"{len(sampled) * size * size} differ from the oracle ({len(sampled)} glyphs); "
              f"{int(counts.sum())} copies of {live} live segments; (segment, row) pairs "
              f"{pairs}, {pairs / (live * size):.3f} of winding.cu's {live * size}")
        print(f"{name} winding_windows: kernel {kernel_ms:.4f} ms on the device "
              f"({b / kernel_ms * 1e3:.0f} glyphs/s), {call_ms:.4f} ms per wrapper call, "
              f"{engine_ms:.4f} ms per engine call; winding.cu on the same batch "
              f"{full_ms:.4f} ms ({kernel_ms / full_ms:.2f}x); bound {b_ms:.5f} ms ({bound_by}; "
              f"{nbytes} B, {ops} FP32 ops, {crossings} crossings); plain version "
              f"{plain_ms:.3f} ms; {plan_text(b, size, size, wins.win_rows)}; winding.cu's "
              f"{plan_text(b, size, size)}")

    for name, (batch, grids, size) in sdf_atlases.items():
        args = packed_to_device(batch, grids, dev)
        b = len(grids)
        out, u8 = sdf_outputs[name]
        t0 = time.perf_counter()
        ref = sdf_ref.sdf_batch(*args, height=size, width=size)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        check(out.shape == ref.shape == (b, size, size) and out.dtype == torch.float32,
              f"{name} SDF shape")
        check(bool(torch.isfinite(out).all()) and float(out.abs().max()) <= sdf_ref.SPREAD_PX,
              f"{name} SDF not finite or outside the spread")
        diff = int((out.view(torch.int32) != ref.view(torch.int32)).sum())
        max_err["sdf"] = max(max_err["sdf"], float((out - ref).abs().max()))
        check(diff == 0, f"{name}: {diff} SDF pixels differ from sdf_ref (bit patterns)")
        check(torch.equal(u8, sdf_ref.sdf_to_u8(ref)), f"{name} sdf_to_u8")
        inside = ~torch.signbit(out).cpu().numpy()
        sampled = range(0, b, SDF_ORACLE_STRIDE)
        mism = 0
        for i in sampled:
            xs, ys = grids[i].sample_coords()
            wo = oracle.winding_at(batch.segments[i], xs[None, :], ys[:, None], contract=False)
            mism += int(((wo != 0) != inside[i]).sum())
        check(mism == 0, f"{name}: {mism} SDF signs differ from the oracle")
        print(f"{name} SDF {size}x{size}: 0 of {out.numel()} pixels differ from sdf_ref "
              f"(int32 bit patterns; sdf_ref took {ref_s:.2f} s); sdf_to_u8 equal; 0 of "
              f"{len(sampled) * size * size} signs differ from the oracle ({len(sampled)} "
              f"glyphs); within the band {int((out.abs() < sdf_ref.SPREAD_PX).sum())}")

        w = winding.winding_batch(*args, height=size, width=size)
        b_ms, bound_by, ops, pairs = sdf_bound(args, out)
        # the pairs the kernel runs its program on: its cull at its own box
        kept = sdf_kept_pairs(*args, height=size, width=size)
        kernel_ms = graph_ms(
            lambda: sdf.sdf_from_winding(*args, w, height=size, width=size))
        call_ms = cuda_ms(lambda: sdf.sdf_batch(*args, height=size, width=size), inner=10)
        plain_ms = cuda_ms(
            lambda: sdf_ref.sdf_from_winding(*args, w, height=size, width=size),
            inner=1, reps=3, warmup=1)
        record["sdf"][name] = dict(ms=kernel_ms, plain_ms=plain_ms, call_ms=call_ms,
                                   bound_ms=b_ms, bound_by=bound_by, bound_ops=ops,
                                   needed_pairs=pairs, kept_pairs=kept,
                                   kept_box=list(SDF_CULL_BOX))
        print(f"{name} sdf: kernel {kernel_ms:.4f} ms on the device "
              f"({b / kernel_ms * 1e3:.0f} glyphs/s, {pairs} needed pairs, {kept} kept at the "
              f"{SDF_CULL_BOX[0]} x {SDF_CULL_BOX[1]} box, {kept / pairs:.3f}x), {call_ms:.4f} ms "
              f"per wrapper call (winding + distance); bound {b_ms:.4f} ms ({bound_by}; "
              f"{ops} FP32 ops); plain version {plain_ms:.3f} ms; its sign's winding() "
              f"{graph_ms(lambda: winding.winding_batch(*args, height=size, width=size)):.4f} "
              f"ms on the device, {plan_text(b, size, size)}")

    b = len(lb_grids)
    lb_ref = loopblinn_ref.loopblinn_batch(*lb_args, height=LB_SIZE, width=LB_SIZE)
    check(lb_out.shape == lb_ref.shape == (b, LB_SIZE, LB_SIZE) and lb_out.dtype == torch.bool,
          "Loop-Blinn atlas shape")
    diff = int((lb_out != lb_ref).sum())
    max_err["loopblinn"] = int((lb_out.int() - lb_ref.int()).abs().max())
    check(diff == 0, f"ascii128: {diff} Loop-Blinn pixels differ from loopblinn_ref")
    t0 = time.perf_counter()
    lb_cpu = loopblinn_ref.loopblinn_batch(
        *triangles_to_device(lb_tris, lb_classes, lb_grids, "cpu"),
        height=LB_SIZE, width=LB_SIZE)
    cpu_s = time.perf_counter() - t0
    diff = int((lb_out.cpu() != lb_cpu).sum())
    check(diff == 0, f"ascii128: {diff} Loop-Blinn pixels differ from loopblinn_ref on the CPU")
    g_cpu = loopblinn.loopblinn_fill(g_mesh, g_grid, device="cpu")
    check(g_fill.shape == (g_grid.height, g_grid.width) and np.array_equal(g_fill, g_cpu),
          "loopblinn_fill('g') differs from the plain version")
    mism = 0
    for ch in LB_WINDING_CHARS:
        glyph = font.get_glyph(ch)[0]
        cgrid = RasterGrid.for_glyph_box(pack_glyph(glyph).box, LB_WINDING_SIZE,
                                         font.info.units_per_em)
        mesh = TriangulatedGlyph.from_glyph(glyph)
        margs = triangles_to_device(*loopblinn.pack_meshes([mesh]), [cgrid], dev)
        fill = loopblinn.loopblinn_batch(*margs, height=cgrid.height, width=cgrid.width,
                                         sample_offset=LB_WINDING_OFFSET)
        seg = torch.from_numpy(glyph_segments(glyph))[None].to(dev)
        w = winding.winding_batch(seg, *margs[2:], height=cgrid.height, width=cgrid.width,
                                  sample_offset=LB_WINDING_OFFSET)
        mism += int((fill != (w != 0)).sum())
    check(mism == 0, f"{mism} Loop-Blinn pixels differ from the winding fill at tie-free offsets")
    print(f"ascii128 Loop-Blinn: 0 of {lb_out.numel()} pixels differ from loopblinn_ref on "
          f"the card, 0 from it on the CPU (took {cpu_s:.2f} s); 'g' fill {g_grid.height}x"
          f"{g_grid.width} equals the plain version; {LB_WINDING_CHARS!r} @"
          f"{LB_WINDING_SIZE} at offset (1/3, 1/3) equal the winding fill; "
          f"covered {int(lb_out.sum())}")

    def lb_kernel():
        return loopblinn.loopblinn_batch(*lb_args, height=LB_SIZE, width=LB_SIZE)

    nbytes = loopblinn_bytes(lb_classes, LB_SIZE, LB_SIZE)
    ops, pairs = loopblinn_work(*lb_args, height=LB_SIZE, width=LB_SIZE)
    b_ms, bound_by = bound_ms(nbytes, ops)
    kernel_ms = graph_ms(lb_kernel)
    call_ms = cuda_ms(lb_kernel, inner=10)
    # the same launch with no triangles: the blocks, the anchors and the output
    no_tris = (lb_args[0][:, :0].contiguous(), lb_args[1][:, :0].contiguous(), *lb_args[2:])
    empty_ms = graph_ms(
        lambda: loopblinn.loopblinn_batch(*no_tris, height=LB_SIZE, width=LB_SIZE))
    plain_ms = cuda_ms(
        lambda: loopblinn_ref.loopblinn_batch(*lb_args, height=LB_SIZE, width=LB_SIZE),
        inner=1, reps=5, warmup=1)
    record["loopblinn"]["ascii128"] = dict(
        ms=kernel_ms, plain_ms=plain_ms, call_ms=call_ms, no_triangles_ms=empty_ms,
        bound_ms=b_ms, bound_by=bound_by, bound_bytes=nbytes, bound_ops=ops,
        inside_pairs=pairs, plain_cpu_s=cpu_s,
        plan=loopblinn.plan(b, lb_tris.shape[1], LB_SIZE, LB_SIZE))
    print(f"ascii128 loopblinn: kernel {kernel_ms:.4f} ms on the device "
          f"({b / kernel_ms * 1e3:.0f} glyphs/s; {empty_ms:.4f} ms with no triangles), "
          f"{call_ms:.4f} ms per wrapper call; bound {b_ms:.5f} ms ({bound_by}; {nbytes} B, "
          f"{ops} FP32 ops, {pairs} inside pairs); plain version {plain_ms:.3f} ms; "
          f"{lb_plan_text(b, lb_tris.shape[1], LB_SIZE, LB_SIZE)}; 'g' "
          f"{lb_plan_text(1, len(g_mesh.triangles), g_grid.height, g_grid.width)}")

    frames5 = [torch.from_numpy(f).to(dev) for f in frames5]  # the session's host frames
    for name, renderer, views, frames in (("config5", sess5.renderer, views5, frames5),
                                          ("page4k", page4k, views4k, frames4k)):
        h, w = renderer.height, renderer.width
        per_frame = []
        ref_s = 0.0
        for k, (view, frame) in enumerate(zip(views, frames)):
            check(frame.shape == (h, w) and frame.dtype == torch.uint8, f"{name} frame shape")
            inputs = renderer.page_inputs(view)
            t0 = time.perf_counter()
            want = page_ref.direct_page(*inputs, page_h=h, page_w=w, mode="winding")
            torch.cuda.synchronize()
            ref_s += time.perf_counter() - t0
            diff = int((frame != page_ref.finish(want, "fill")).sum())
            check(diff == 0, f"{name} frame {k}: {diff} pixels differ from page_ref")
            got = page.direct_page(*inputs, page_h=h, page_w=w, mode="winding")
            max_err["page"] = max(max_err["page"], int((got - want).abs().max()))
            check(torch.equal(got, want), f"{name} frame {k}: the int32 page differs from "
                  "page_ref's")
            # the winding of every pair: the same page where no root strays
            every_pair = int((got != winding_page(inputs, h, w)).sum())
            if name == "config5" and k == 0:  # ViewTransform.init: the transform is exact
                check(every_pair == 0, f"config5 first frame: {every_pair} pixels differ from "
                      "the winding kernel at batch 1")
            q = page_ref.transform_segments(*inputs).reshape(-1, 6)
            ops, needed, crossings = page_work(*inputs, page_h=h, page_w=w)
            nbytes = page_bytes(len(inputs[0]), len(inputs[2]), h, w, "fill")
            b_ms, bound_by = bound_ms(nbytes, ops)
            per_frame.append(dict(
                ms=graph_ms(lambda: page.direct_page(*inputs, page_h=h, page_w=w), calls=10),
                bound_ms=b_ms, bound_by=bound_by, bound_ops=ops,
                visited_pairs=int(page_ref.page_rows(q, h - 1, h, w).sum()),
                needed_pairs=needed, crossings=crossings, inked=int((frame != 0).sum()),
                every_pair_differs=every_pair))
        print(f"{name}: {len(frames)} frames {h}x{w}: 0 pixels differ from page_ref (int32 and "
              f"fill; page_ref took {ref_s:.2f} s in all)"
              + ("; the first frame equals the winding kernel at batch 1" if name == "config5"
                 else "") + "; per frame:")
        for k, f in enumerate(per_frame):
            print(f"  {name} frame {k}: {f['ms']:.4f} ms, bound {f['bound_ms']:.5f} ms "
                  f"({f['bound_by']}), visited {f['visited_pairs']}, crossings "
                  f"{f['crossings']}, inked {f['inked']}, every pair differs "
                  f"{f['every_pair_differs']}")

        inputs = renderer.page_inputs(views[0])
        if name == "config5":
            ref = page_ref.direct_page(*inputs, page_h=h, page_w=w, mode="winding")
            y0, rows = PAGE_BAND
            check(torch.equal(band5, frames[0][y0 : y0 + rows]),
                  "config5 band differs from the frame's rows")
            check(torch.equal(band5, page_ref.direct_page(*inputs, y0, page_h=h, page_w=w,
                                                          out_h=rows)),
                  "config5 band differs from page_ref's")
            last = page_ref.direct_page(*renderer.page_inputs(views[-1]), page_h=h, page_w=w,
                                        mode="gray").cpu().numpy()
            check(gray5.shape == (h, w, 4) and (gray5[..., 3] == 255).all()
                  and all(np.array_equal(gray5[..., c], last) for c in range(3)),
                  "config5 d frame: not page_ref's debug gray, opaque")
            fill_last = frames[-1].cpu().numpy()
            check(all(np.array_equal(clear5[..., c], fill_last) for c in range(4)),
                  "config5 t frame: not the last fill with alpha = coverage")
            q = page_ref.transform_segments(*inputs).cpu().numpy()
            rows_o = np.arange(0, h, PAGE_ORACLE_STRIDE)
            t1 = time.perf_counter()
            wo = oracle_rows(q, w, [(np.float32(h - 1 - r), 0.0) for r in rows_o])
            oracle_s = time.perf_counter() - t1
            mism = int((wo != ref[rows_o].cpu().numpy()).sum())
            check(mism == 0, f"config5: {mism} pixels differ from the oracle")
            print(f"config5: the band {PAGE_BAND} equals the frame's rows and page_ref's band; "
                  f"the d frame is page_ref's debug gray at the last view, opaque; the t frame "
                  f"is the last fill with alpha = coverage; 0 of {len(rows_o) * w} pixels on "
                  f"every {PAGE_ORACLE_STRIDE}th row of the first frame differ from the oracle "
                  f"(took {oracle_s:.1f} s)")
        else:
            y0, rows = STRESS_REF_BAND
            ref = page_ref.direct_page(*inputs, y0, page_h=h, page_w=w, out_h=rows,
                                       mode="winding")
            got = page.direct_page(*inputs, y0, page_h=h, page_w=w, out_h=rows, mode="winding")
            check(torch.equal(got, ref), "page4k band differs from page_ref's")
            print(f"page4k: the band [{y0}, {y0 + rows}) equals page_ref's")

        first = per_frame[0]
        call_ms = cuda_ms(lambda: renderer.render_direct(views[0]), inner=10)
        flat = page_ref.transform_segments(*inputs)[None].contiguous()
        anchors = (torch.zeros(1, dtype=torch.int32, device=dev),
                   torch.full((1,), h - 1, dtype=torch.int32, device=dev))
        winding_ms = graph_ms(
            lambda: winding.winding_batch(flat, *anchors, 1.0, height=h, width=w), calls=5)
        d2h_ms = cuda_ms(lambda: frames[0].cpu(), inner=1)
        plain_ms = cuda_ms(lambda: page_ref.direct_page(*inputs, page_h=h, page_w=w), inner=1,
                           reps=3, warmup=1)

        def mean(key):
            return statistics.fmean(f[key] for f in per_frame)

        # the frames' mean in the main keys: what the traffic costs a frame
        rec = dict(ms=mean("ms"), plain_ms=plain_ms, call_ms=call_ms,
                   bound_ms=mean("bound_ms"), bound_by=first["bound_by"],
                   frames=len(per_frame), bound_ops=mean("bound_ops"),
                   bound_bytes=page_bytes(len(inputs[0]), len(inputs[2]), h, w, "fill"),
                   segments=len(inputs[0]), instances=len(inputs[2]),
                   visited_pairs=mean("visited_pairs"), needed_pairs=mean("needed_pairs"),
                   all_pairs=len(inputs[0]) * h, crossings=mean("crossings"),
                   max_ms=max(f["ms"] for f in per_frame),
                   first_ms=first["ms"], first_bound_ms=first["bound_ms"],
                   first_visited_pairs=first["visited_pairs"], first_crossings=first["crossings"],
                   winding_cu_first_ms=winding_ms, frame_d2h_ms=d2h_ms,
                   host_layout_s=pack_s[f"{name}_layout"], plain_all_frames_s=ref_s,
                   inked_first=first["inked"], inked_min=min(f["inked"] for f in per_frame),
                   inked_max=max(f["inked"] for f in per_frame),
                   every_pair_differs_max=max(f["every_pair_differs"] for f in per_frame))
        if name == "page4k":
            y0, rows = STRESS_REF_BAND
            rec["band_ms"] = graph_ms(
                lambda: page.direct_page(*inputs, y0, page_h=h, page_w=w, out_h=rows))
        if name == "config5":  # the user's frame: the session's, the page to the host included
            rec.update(session_frame_ms=stats5["mean_ms"], session_p99_ms=stats5["p99_ms"],
                       session_compute_ms=stats5["compute_ms"])
        record["page"][name] = rec
        print(f"{name} page: S {len(inputs[0])} segments, {len(inputs[2])} instances, "
              f"{len(per_frame)} frames; mean per frame: kernel {rec['ms']:.4f} ms on the "
              f"device (max {rec['max_ms']:.4f}), bound {rec['bound_ms']:.5f} ms "
              f"({rec['bound_ms'] / rec['ms']:.1%} of the kernel's time), visited pairs "
              f"{rec['visited_pairs']:.0f}, needed {rec['needed_pairs']:.0f}, crossings "
              f"{rec['crossings']:.0f}; first frame: kernel {first['ms']:.4f} ms, bound "
              f"{first['bound_ms']:.5f} ms, visited {first['visited_pairs']}, render_direct "
              f"{call_ms:.4f} ms per call, winding.cu on the same page {winding_ms:.4f} ms, "
              f"frame to host {d2h_ms:.4f} ms, plain version {plain_ms:.3f} ms")

    lattice = [(ox, oy) for oy, oxs in page_ref.msaa_lattice() for ox in oxs]
    for name, renderer, views, frames, stats in (
            ("config5", sess5m.renderer, views5m, msaa5, stats5m),
            ("narrow", sessn.renderer, viewsn, msaan, statsn),
            ("page4k", page4k, views4k, msaa4k, None)):
        h, w = renderer.height, renderer.width
        frames = [torch.as_tensor(f).to(dev) for f in frames]  # the sessions' are host arrays
        per_frame = []
        ref_s = 0.0
        for k, (view, frame) in enumerate(zip(views, frames)):
            check(frame.shape == (h, w) and frame.dtype == torch.uint8, f"{name} MSAA shape")
            inputs = renderer.page_inputs(view)
            t0 = time.perf_counter()
            want = page_ref.direct_page_msaa(*inputs, page_h=h, page_w=w)
            torch.cuda.synchronize()
            ref_s += time.perf_counter() - t0
            diff = int((frame != want).sum())
            max_err["page_msaa"] = max(max_err["page_msaa"],
                                       int((frame.int() - want.int()).abs().max()))
            check(diff == 0, f"{name} MSAA frame {k}: {diff} pixels differ from page_ref")
            check(set(torch.unique(frame).tolist()) <= {0, 63, 127, 191, 255},
                  f"{name} MSAA frame {k}: a value off the 2 x 2 lattice")
            q = page_ref.transform_segments(*inputs).reshape(-1, 6)
            ops, needed, crossings = page_msaa_work(*inputs, page_h=h, page_w=w)
            nbytes = page_msaa_bytes(len(inputs[0]), len(inputs[2]), h, w)
            b_ms, bound_by = bound_ms(nbytes, ops)
            per_frame.append(dict(
                ms=graph_ms(lambda: page.direct_page_msaa(*inputs, page_h=h, page_w=w),
                            calls=10),
                bound_ms=b_ms, bound_by=bound_by, bound_ops=ops, needed_pairs=needed,
                crossings=crossings,
                visited_pairs=sum(int(page_ref.page_rows(q, h - 1, h, w, oy, oxs).sum())
                                  for oy, oxs in page_ref.msaa_lattice()),
                partial=int(((frame > 0) & (frame < 255)).sum())))
        inputs = renderer.page_inputs(views[0])
        note = ""
        if name != "page4k":  # the first view: the transform is exact, no root strays
            passes = [winding_page(inputs, h, w, off) for off in lattice]
            diff = int((frames[0] != msaa_from_windings(passes)).sum())
            check(diff == 0, f"{name} first MSAA frame: {diff} pixels differ from four "
                  "winding-kernel passes")
            note = "; the first frame equals four winding-kernel passes at the sample offsets"
        if name == "config5":
            q = page_ref.transform_segments(*inputs).cpu().numpy()
            rows_o = np.array(MSAA_ORACLE_ROWS)
            t1 = time.perf_counter()
            wo = oracle_rows(q, w, [(np.float32(h - 1 - r) + np.float32(oy), ox)
                                    for ox, oy in lattice for r in rows_o])
            wo = wo.reshape(len(lattice), len(rows_o), w)
            oracle_s = time.perf_counter() - t1
            mism = int((msaa_from_windings(wo) != frames[0][rows_o].cpu().numpy()).sum())
            check(mism == 0, f"config5 first MSAA frame: {mism} pixels differ from the oracle")
            note += (f"; 0 of {len(rows_o) * w} pixels on rows {rows_o.tolist()} differ from the "
                     f"oracle at the four offsets (took {oracle_s:.1f} s)")
        print(f"{name} MSAA: {len(frames)} frames {h}x{w}: 0 pixels differ from page_ref "
              f"(page_ref took {ref_s:.2f} s in all){note}; per frame:")
        for k, f in enumerate(per_frame):
            print(f"  {name} MSAA frame {k}: {f['ms']:.4f} ms, bound {f['bound_ms']:.5f} ms "
                  f"({f['bound_by']}), visited {f['visited_pairs']}, needed "
                  f"{f['needed_pairs']}, crossings {f['crossings']}, partial {f['partial']}")

        first = per_frame[0]
        call_ms = cuda_ms(lambda: renderer.render_direct(views[0], msaa=True), inner=10)
        four_ms = graph_ms(lambda: [page.direct_page(*inputs, page_h=h, page_w=w,
                                                     sample_offset=off) for off in lattice],
                           calls=5)
        plain_ms = cuda_ms(lambda: page_ref.direct_page_msaa(*inputs, page_h=h, page_w=w),
                           inner=1, reps=3, warmup=1)

        def mean(key):
            return statistics.fmean(f[key] for f in per_frame)

        rec = dict(ms=mean("ms"), plain_ms=plain_ms, call_ms=call_ms,
                   bound_ms=mean("bound_ms"), bound_by=first["bound_by"],
                   frames=len(per_frame), bound_ops=mean("bound_ops"),
                   bound_bytes=page_msaa_bytes(len(inputs[0]), len(inputs[2]), h, w),
                   segments=len(inputs[0]), visited_pairs=mean("visited_pairs"),
                   needed_pairs=mean("needed_pairs"), crossings=mean("crossings"),
                   max_ms=max(f["ms"] for f in per_frame), first_ms=first["ms"],
                   first_bound_ms=first["bound_ms"], four_page_passes_first_ms=four_ms,
                   plain_all_frames_s=ref_s, frames_ms=[f["ms"] for f in per_frame],
                   frames_bound_ms=[f["bound_ms"] for f in per_frame])
        if stats is not None:  # the user's frame: the session's, the page to the host included
            rec.update(session_frame_ms=stats["mean_ms"], session_p99_ms=stats["p99_ms"],
                       session_compute_ms=stats["compute_ms"])
        record["page_msaa"][name] = rec
        single = record["page"].get(name, {}).get("ms")
        print(f"{name} MSAA page: S {len(inputs[0])} segments, {len(per_frame)} frames; mean "
              f"per frame: kernel {rec['ms']:.4f} ms on the device (max {rec['max_ms']:.4f}"
              + (f"; {rec['ms'] / single:.2f}x the single-sample page's {single:.4f}"
                 if single else "")
              + f"), bound {rec['bound_ms']:.5f} ms ({rec['bound_ms'] / rec['ms']:.1%} of the "
              f"kernel's time), visited pairs {rec['visited_pairs']:.0f}, needed "
              f"{rec['needed_pairs']:.0f}, crossings {rec['crossings']:.0f}; first frame: "
              f"kernel {first['ms']:.4f} ms, four single-sample page passes {four_ms:.4f} ms, "
              f"render_direct {call_ms:.4f} ms per call, plain version {plain_ms:.3f} ms"
              + (f"; session frame {stats['mean_ms']:.3f} ms (p99 {stats['p99_ms']:.3f}), "
                 f"render alone {stats['compute_ms']:.3f} ms" if stats else ""))

    # --- sharded path and the dry runs (on the results above) -----------------
    shard_record, sharded_launches = sharded_phase(
        dev, atlases, outputs, cov_outputs, sdf_atlases, sdf_outputs, lb_args, lb_out,
        (sess5, views5[0], frames5[0]))

    want = np.where(oracle.winding_map(packed.segments, grid, contract=False) != 0,
                    255, 0).astype(np.uint8)
    check(decoded.shape == (grid.height, grid.width, 3), "quick start QOI shape")
    check(all(np.array_equal(decoded[:, :, c], want) for c in range(3)),
          "quick start QOI differs from the oracle fill")
    print(f"quick start: 'A' @256 {grid.height}x{grid.width} QOI round trip "
          "equals the oracle fill")

    ref_mask = (winding_ref.winding_batch(*example_args, height=128, width=640) != 0)
    check(mask.shape == (8, 128, 640) and bool(torch.isfinite(mask).all()),
          "entry() output shape or values")
    check(torch.equal(mask, ref_mask.to(torch.float32)), "entry() differs from winding_ref")
    print(f"entry(): [8, 128, 640] mask equals winding_ref, inked {int(mask.sum())}")
    # the fill path's other two launches, timed beside their bounds
    qs_args = to_device(np.asarray(packed.segments, np.float32)[None], [grid.min_x],
                        [grid.max_y], grid.scale, dev)
    for name, args, (h, w) in (("quick_start", qs_args, (grid.height, grid.width)),
                               ("entry", example_args, (128, 640))):
        segs = args[0].cpu().numpy()
        ops, nbytes, _ = winding_work(segs, live_counts(segs), args[2], args[3], height=h,
                                      width=w)
        b_ms, bound_by = bound_ms(nbytes, ops)
        record["winding"][name] = dict(
            ms=graph_ms(lambda args=args, h=h, w=w: winding.winding_batch(*args, height=h,
                                                                          width=w)),
            bound_ms=b_ms, bound_by=bound_by, bound_ops=ops)
        print(f"{name} winding: {len(segs)} glyphs of {h}x{w}, kernel "
              f"{record['winding'][name]['ms']:.4f} ms on the device, bound {b_ms:.5f} ms "
              f"({bound_by}); {plan_text(len(segs), h, w)}")

    # --- roofline probe (K13), once --------------------------------------------
    roofline_entry = roofline_phase(dev, record, atlases["ascii256"][:2])

    # --- the row-banded strip atlas (K5, K6), once ------------------------------
    (record["winding_banded"], banded_launches, max_err["winding_banded"],
     pack_s["banded_cases"]) = banded_phase(dev)

    # --- the edit path (K7 on 256-row bands), once -------------------------------
    edit_record, edit_launches = edit_phase(dev, font, stats5["mean_ms"])

    # --- the command line (python -m fontrx_torch), once, in process ------------
    with tempfile.TemporaryDirectory() as tmp:
        cli_record, cli_launches = cli_phase(dev, pathlib.Path(tmp))

    # --- the colour path (COLR v0: K9 and the src-over composite), once -------
    with tempfile.TemporaryDirectory() as tmp:
        color_record, color_launches, color_err = color_phase(dev, pathlib.Path(tmp))
    max_err["coverage"] = max(max_err["coverage"], color_err)

    # --- host baseline and the card ------------------------------------------
    batch, grids, _ = atlases["ascii256"]
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        for i in range(2):
            xs, ys = grids[i].sample_coords()
            oracle.winding_at(batch.segments[i], xs[None, :], ys[:, None])
        reps.append((time.perf_counter() - t0) / 2)
    print(f"host oracle @256: {1.0 / min(reps):.3f} glyphs/s (2 glyphs, best of 3)")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])

    def entry_of(kname, replaces, launches, main_atlas="ascii256", source=None, **extra):
        main = record[kname][main_atlas]
        return {
            "name": kname, "route": "cuda",
            "source": source or f"fontrx_torch/csrc/{kname}.cu",
            "replaces": replaces, **extra, "launches": launches + cli_launches[kname],
            "cli_launches": cli_launches[kname],
            "max_abs_err": max_err[kname],
            # the main atlas in the main keys, the other atlases beside them
            **main, "library_ms": None,
            **{f"{atlas}_{key}": value for atlas, rec in record[kname].items()
               if atlas != main_atlas for key, value in rec.items()},
        }

    print(json.dumps({"kernels": [
        entry_of("winding", "fontrx/kernels/winding_pallas_v2.py:628", winding_launches,
                 also_replaces=["fontrx/kernels/winding_dense.py:297",
                                "fontrx/kernels/winding_pallas.py:136"],
                 sharded_launches=sharded_launches["winding"],
                 sharded={k: v for k, v in shard_record.items()
                          if k in ("cjk64_glyphs4", "cjk64_2x2", "ascii256_2x2")}),
        entry_of("coverage", "fontrx/kernels/coverage_pallas.py:211",
                 coverage_launches + color_launches, samples=SAMPLES,
                 sharded_launches=sharded_launches["coverage"],
                 sharded=shard_record["cjk64_coverage_glyphs4"], color_launches=color_launches,
                 color=color_record),
        entry_of("sdf", "fontrx/kernels/sdf_pallas.py:180", sdf_launches,
                 also_replaces="fontrx/kernels/sdf_pallas.py:605",
                 spread_px=sdf_ref.SPREAD_PX, winding_launches=sdf_winding_launches,
                 sharded_launches=sharded_launches["sdf"],
                 sharded=shard_record["cjk32_sdf_glyphs4"]),
        entry_of("loopblinn", "fontrx/kernels/loopblinn.py:314", lb_launches,
                 main_atlas="ascii128", sharded_launches=sharded_launches["loopblinn"],
                 sharded=shard_record["ascii128_loopblinn_glyphs4"]),
        entry_of("page", "fontrx/kernels/winding_page.py:267", page_launches + edit_launches,
                 main_atlas="config5", sharded_launches=sharded_launches["page"],
                 sharded=shard_record["config5_rows4"], page_path_launches=page_launches,
                 edit=edit_record),
        entry_of("page_msaa", "fontrx/kernels/winding_page.py:537", msaa_launches,
                 main_atlas="config5", source="fontrx_torch/csrc/page.cu", samples=SAMPLES),
        entry_of("winding_windows", "fontrx/kernels/winding_dense.py:673", windows_launches,
                 main_atlas="cjk64", source="fontrx_torch/csrc/winding.cu"),
        entry_of("winding_banded", "fontrx/kernels/winding_pallas_v2.py:555", banded_launches,
                 main_atlas="dejavu64", also_replaces="fontrx/kernels/winding_dense.py:393",
                 source="fontrx_torch/csrc/winding.cu"),
        roofline_entry,
    ], "host_pack_s": pack_s, "dryruns": shard_record["dryruns"], "cli": cli_record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
