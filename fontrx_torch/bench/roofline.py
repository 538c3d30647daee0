"""The port's roofline probe: the rates an H100 reaches on the op mixes of
the port's kernels, and its memory bandwidth.

The counterpart of the JAX package's ``tools/tpu_probes/tpu_roofline.py``.
On a machine with a CUDA card and the CUDA toolkit:

    python -m fontrx_torch.bench.roofline

1. **The four op mixes** (K13: ``kernels/roofline.py``, ``csrc/roofline.cu``):
   1024 dependent applications of one op to every element of a
   ``[16, 512, 128]`` tensor. A mix's time comes from CUDA events around
   CUDA-graph replays (median of 20), its rate from the reference's op counts
   (``roofline_ref.MIXES``). Beside the rate stand its issue bound and the
   data sheet's 67 TFLOP/s (``bound.FP32_OPS_PER_S``). The issue bound counts
   each instruction of the kernel's loop body in its SASS on the pipe that
   issues it (``PIPES``), at the card's own SM count and maximum SM clock.
   The SASS is also the check that the compiler kept every application
   (``MODEL``): a folded or fused chain gives the same results.
2. **The HBM leg**: ``base + dep`` over 256 MiB of float32, the reference's
   ``bench_hbm``, as one plain torch add (the reference leaves it to XLA,
   outside Pallas): the bytes read and written over the time.
3. **The port's own work on ascii256**, in place of the reference's model of
   its TPU kernel: the FP32 operations and bytes of ``winding()`` on the 94
   printable ASCII glyphs of DejaVu Sans at 256 px (``bound.winding_work``,
   as ``chip_smoke.py`` counts them), and its bound under the data sheet's
   rates and under the measured ones (the f32 mul+add rate, the HBM leg).

Every printed line names the card and its power limit. ``run`` returns the
record; ``chip_smoke.py`` runs it and holds the kernel to its plain version.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import subprocess
from collections import Counter

import numpy as np
import torch

from fontrx_torch import bound
from fontrx_torch import device as _device
from fontrx_torch.bench.timing import graph_ms
from fontrx_torch.convert import grid_anchors
from fontrx_torch.engine.atlas import pack_charset
from fontrx_torch.font.font import Font
from fontrx_torch.kernels import _build, roofline, roofline_ref
from fontrx_torch.kernels.grid import RasterGrid

SHAPE = (16, 512, 128)   # [GRID, R, W] (tpu_roofline.py:31-34)
ITERS = 128 * 8          # K * UNROLL applications an element (tpu_roofline.py:32-33)
CALLS = 20               # launches a CUDA graph replays (graph_ms)
HBM_BYTES = 256 * 2**20  # bench_hbm's 256 MB of float32 (tpu_roofline.py:103-105)

DEJAVU = pathlib.Path(__file__).resolve().parents[1] / "data" / "DejaVuSans.ttf"
ASCII = list(range(33, 127))
ASCII_SIZE = 256

# Lanes per SM per clock of each pipe on compute capability 9.0: the CUDA C++
# Programming Guide, "Arithmetic Instructions", throughput table, and its
# "Compute Capability 9.0" section (4 warp schedulers an SM).
PIPES = {
    "fp32": 128,      # "32-bit floating-point add, multiply, multiply-add"
    "alu": 64,        # "32-bit integer add, ..." and "compare, minimum, maximum"
    "imad": 64,       # "32-bit integer multiply, multiply-add, ..."
    "dispatch": 128,  # every instruction: each scheduler issues one warp
                      # instruction (32 threads) a clock
}
# SASS opcode (before its first '.') -> the pipe it issues on besides
# dispatch. FMUL, FADD, IADD3, ISETP, FSETP and IMAD are operations of the
# Guide's table above. FSEL and VIADD are not in it: their pipes are
# inferred, and only the measured times support them (H100 80GB HBM3 at
# 700 W). FSEL, a select, is counted with the compares on the integer ALU:
# the cmp+select+add mix then reaches 91-92% of its ALU bound, as the other
# mixes reach 87-93% of theirs; counted on the FP32 pipe, its bound would be
# dispatch, 0.100 ms, reached at 70-71%. VIADD, where ptxas puts part of a
# chain of adds (the rest on IADD3), is counted on the multiply-add
# datapath: counted on the ALU with the IADD3s, the integer mixes' bound
# would be 0.066 ms, longer than the 0.040 ms they take. The uniform
# datapath (U*) and branches take a dispatch slot only.
PIPE_OF = {
    "FMUL": "fp32", "FADD": "fp32",
    "IADD3": "alu", "ISETP": "alu", "FSETP": "alu", "FSEL": "alu",
    "VIADD": "imad", "IMAD": "imad",
}
# mix -> the SASS each application must issue at least once; "add3" is an
# IADD3 or VIADD of the immediate 3 (a folded chain adds a multiple of 3)
MODEL = {
    "f32_mul_add": {"FMUL": 1, "FADD": 1},
    "i32_add": {"add3": 1},
    "i16_add": {"add3": 1},
    "f32_cmp_select_add": {"FSETP": 1, "FSEL": 1, "FADD": 1},
}
FORBIDDEN = ("FFMA",)  # -fmad=false: no multiply and add contracted

_INSTR = re.compile(r"/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def cuobjdump_path() -> str | None:
    """``cuobjdump`` beside the ``nvcc`` the kernels are built with, else on
    ``PATH``."""
    nvcc = _build.nvcc_path()
    if nvcc is not None:
        tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
        if os.access(tool, os.X_OK):
            return tool
    return shutil.which("cuobjdump")


def parse_loops(sass: str) -> dict[str, list[tuple[str, str]]]:
    """Each function's loop body in ``cuobjdump -sass`` text: its
    ``(opcode, operands)`` from the target of its one backward branch to the
    branch (cuobjdump prints branch targets as addresses). Raises
    ``RuntimeError`` for a function with another number of loops."""
    loops = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        code = [(int(m.group(1), 16), m.group(2), m.group(3).strip())
                for m in map(_INSTR.search, part.splitlines()) if m]
        back = []
        for addr, op, args in code:
            target = _TARGET.search(args) if op.split(".")[0] == "BRA" else None
            # the trap after EXIT branches to itself
            if target and int(target.group(1), 16) < addr:
                back.append((int(target.group(1), 16), addr))
        if len(back) != 1:
            raise RuntimeError(f"{name}: {len(back)} loops in the SASS, expected 1")
        (start, end), = back
        loops[name] = [(op, args) for addr, op, args in code if start <= addr <= end]
    return loops


def sass_loops(path) -> dict[str, list[tuple[str, str]]]:
    """``parse_loops`` of the SASS in the library at ``path``. Raises
    ``RuntimeError`` when there is no ``cuobjdump``."""
    tool = cuobjdump_path()
    if tool is None:
        raise RuntimeError("cuobjdump not found: the SASS check cannot run")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    return parse_loops(sass)


def loop_counts(body) -> Counter:
    """A loop body's instructions by opcode (before its first '.'), and
    ``add3``: the IADD3s and VIADDs of the immediate 3."""
    counts = Counter()
    for op, args in body:
        base = op.split(".")[0]
        counts[base] += 1
        if base in ("IADD3", "VIADD") and "0x3" in [a.strip() for a in args.split(",")]:
            counts["add3"] += 1
    return counts


def check_model(mix, counts, unroll) -> None:
    """Raise ``RuntimeError`` unless each of the loop's ``unroll``
    applications issues the instructions ``MODEL`` gives ``mix``, and none
    of ``FORBIDDEN``."""
    for kind, per_application in MODEL[mix].items():
        if counts[kind] < per_application * unroll:
            raise RuntimeError(f"{mix}: {counts[kind]} {kind} in a loop of {unroll} applications, "
                               f"the model needs {per_application * unroll}: the chain was folded")
    for kind in FORBIDDEN:
        if counts[kind]:
            raise RuntimeError(f"{mix}: {counts[kind]} {kind} in the loop")


def pipe_counts(body) -> Counter:
    """A loop body's instructions on each pipe of ``PIPES``. Raises
    ``RuntimeError`` for an opcode the table does not place."""
    pipes = Counter(dispatch=len(body))
    for op, _ in body:
        base = op.split(".")[0]
        if base == "BRA" or base.startswith("U"):
            continue
        if base not in PIPE_OF:
            raise RuntimeError(f"no pipe for {op} in the loop: extend PIPE_OF")
        pipes[PIPE_OF[base]] += 1
    return pipes


def issue_bound_ms(pipes, *, threads, trips, sms, clock_hz) -> tuple[float, str]:
    """The least time ``threads`` threads take to issue ``trips`` trips of a
    loop with ``pipes`` instructions on each pipe, in ms, and the pipe that
    binds it."""
    t = {p: n * trips * threads / (sms * PIPES[p] * clock_hz) for p, n in pipes.items()}
    worst = max(t, key=t.get)
    return t[worst] * 1e3, worst


def smi(query: str, index: int) -> str:
    """``nvidia-smi --query-gpu=<query> --format=csv,noheader`` for card
    ``index``."""
    out = subprocess.run(["nvidia-smi", "-i", str(index), f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def card(dev) -> dict:
    """The card's name and power limit (as ``nvidia-smi`` gives them), its SM
    count and its maximum SM clock."""
    index = dev.index or 0
    return {"name_power": smi("name,power.limit", index),
            "sms": torch.cuda.get_device_properties(dev).multi_processor_count,
            "max_sm_clock_mhz": float(smi("clocks.max.sm", index).split()[0])}


def pack_ascii256():
    """The 94 printable ASCII glyphs of DejaVu Sans, packed, and their
    256 px tiles: ``(batch, grids)``."""
    font = Font.open(DEJAVU)
    batch = pack_charset(font, ASCII)
    grids = [RasterGrid.fixed_tile(tuple(box), ASCII_SIZE, font.info.units_per_em, ASCII_SIZE)
             for box in np.asarray(batch.boxes)]
    return batch, grids


def run(ascii256, device=None):
    """Run the probe on a CUDA card (``device``, else the first), with
    ascii256's ``(batch, grids)`` (``pack_ascii256``). Returns the record
    and, per mix, its input and the kernel's output."""
    dev = _device.require_cuda() if device is None else torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the probe measures a CUDA card, not {dev}")
    info = card(dev)
    clock_hz = info["max_sm_clock_mhz"] * 1e6
    loops = sass_loops(_build.build("roofline"))
    unroll = roofline.unroll()
    mixes, outputs = {}, {}
    for mix, (dtype, ops_per_application) in roofline_ref.MIXES.items():
        body = loops[f"roofline_{mix}"]
        counts = loop_counts(body)
        check_model(mix, counts, unroll)
        pipes = pipe_counts(body)
        x = roofline_ref.initial(mix, SHAPE, dev)
        outputs[mix] = (x, roofline.elementwise(mix, x, ITERS))
        ms = graph_ms(lambda mix=mix, x=x: roofline.elementwise(mix, x, ITERS), calls=CALLS)
        ops = x.numel() * ITERS * ops_per_application
        b_ms, pipe = issue_bound_ms(pipes, threads=x.numel(), trips=ITERS // unroll,
                                    sms=info["sms"], clock_hz=clock_hz)
        mixes[mix] = dict(ms=ms, ops=ops, tops=ops / ms / 1e9, issue_bound_ms=b_ms,
                          issue_bound_pipe=pipe, issue_bound_tops=ops / b_ms / 1e9,
                          of_datasheet=ops / (ms * 1e-3) / bound.FP32_OPS_PER_S,
                          sass=dict(counts), pipes=dict(pipes))

    base = torch.arange(HBM_BYTES // 4, dtype=torch.float32, device=dev)
    dep = torch.zeros((), dtype=torch.float32, device=dev)
    hbm_ms = graph_ms(lambda: base + dep, calls=CALLS)
    moved = 2 * HBM_BYTES  # read once, written once
    hbm = dict(ms=hbm_ms, bytes=moved, gb_per_s=moved / hbm_ms / 1e6,
               of_datasheet=moved / (hbm_ms * 1e-3) / bound.HBM_BYTES_PER_S)
    del base

    batch, grids = ascii256
    _, max_y, scale = grid_anchors(grids)
    ops, nbytes, _ = bound.winding_work(batch.segments, batch.seg_counts, max_y, scale,
                                        height=grids[0].height, width=grids[0].width)
    sheet_ms, sheet_by = bound.bound_ms(nbytes, ops)
    fp32_per_s = mixes["f32_mul_add"]["tops"] * 1e12
    t_bytes, t_ops = nbytes / (hbm["gb_per_s"] * 1e9), ops / fp32_per_s
    ascii256 = dict(ops=ops, bytes=nbytes, datasheet_bound_ms=sheet_ms,
                    datasheet_bound_by=sheet_by, measured_bound_ms=max(t_bytes, t_ops) * 1e3,
                    measured_bound_by="bytes" if t_bytes >= t_ops else "operations")
    return dict(card=info, shape=list(SHAPE), iters=ITERS, unroll=unroll, mixes=mixes,
                hbm=hbm, ascii256=ascii256), outputs


def report(result) -> None:
    """Print the record, one line a number, each beside the card."""
    info = result["card"]
    tag = f"roofline [{info['name_power']}]"
    print(f"{tag}: {info['sms']} SMs, max SM clock {info['max_sm_clock_mhz']:.0f} MHz; "
          f"{result['iters']} applications an element of {result['shape']}, "
          f"{result['unroll']} a loop trip")
    for mix, m in result["mixes"].items():
        print(f"{tag} {mix}: {m['ms']:.4f} ms, {m['tops']:.2f} T op/s; issue bound "
              f"{m['issue_bound_ms']:.4f} ms ({m['issue_bound_pipe']}), "
              f"{m['issue_bound_tops']:.2f} T op/s, reached {m['issue_bound_ms'] / m['ms']:.1%}; "
              f"{m['of_datasheet']:.1%} of the data sheet's 67 TFLOP/s; loop SASS "
              f"{json.dumps(m['sass'], sort_keys=True)}, per pipe {json.dumps(m['pipes'])}")
    h = result["hbm"]
    print(f"{tag} HBM base + dep over {HBM_BYTES >> 20} MiB: {h['ms']:.4f} ms, {h['bytes']} B "
          f"read and written, {h['gb_per_s']:.1f} GB/s, {h['of_datasheet']:.1%} of 3.35 TB/s")
    a = result["ascii256"]
    print(f"{tag} ascii256 winding(): {a['ops']} FP32 ops, {a['bytes']} B; bound "
          f"{a['datasheet_bound_ms']:.5f} ms ({a['datasheet_bound_by']}) at the data sheet's "
          f"rates, {a['measured_bound_ms']:.5f} ms ({a['measured_bound_by']}) at the measured "
          f"f32 mul+add and HBM rates")


def main() -> None:
    result, _ = run(pack_ascii256())
    report(result)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
