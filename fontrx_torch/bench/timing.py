"""Device times on a CUDA card: CUDA events around calls, and around
CUDA-graph replays where the host's launch overhead must not count; the
host's own time a call; and the card's name and power limit to stand beside
them."""

from __future__ import annotations

import statistics
import subprocess
import time

import torch


def cuda_ms(fn, *, inner: int, reps: int = 20, warmup: int = 3) -> float:
    """Median over ``reps`` CUDA-event timings of ``inner`` back-to-back
    calls, in ms per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def host_ms(fn, *, calls: int = 100, reps: int = 5, warmup: int = 3) -> float:
    """Host ms per call of ``fn``: the median over ``reps`` of the host
    clock around ``calls`` back-to-back calls, from an idle card and without
    waiting for it, so the card's time is not counted."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
    torch.cuda.synchronize()
    return statistics.median(times)


def synced_ms(fn, reps: int = 7) -> float:
    """Median host ms of ``fn()`` from a synchronised card to a synchronised
    card, after one warm-up call: what a caller waits for, host work and
    copies to the host included."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def graph_ms(fn, *, calls: int = 20) -> float:
    """Device ms per call of ``fn``: CUDA-event timings of a CUDA graph that
    replays ``calls`` calls, so no host launch overhead is counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up before capture, on a side stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, inner=1) / calls


def card() -> str:
    """``name, power limit`` as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"
