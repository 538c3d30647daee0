"""Device times on a CUDA card: CUDA events around calls, and around
CUDA-graph replays where the host's launch overhead must not count."""

from __future__ import annotations

import statistics

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
