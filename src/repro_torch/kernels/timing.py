"""Device time of a kernel call, for the chip smoke script and the tools.

Imports ``torch`` only; needs a CUDA device when called.
"""
from __future__ import annotations

import torch


def cuda_ms(fn, sets, iters=20, reps=3):
    """Mean device ms of one ``fn(*s)`` call. ``iters`` calls cycling through
    the input ``sets`` (together larger than the 50 MB L2, so each call finds
    its inputs cold, as a layer of the model does) are captured in one CUDA
    graph, which is replayed ``reps`` times between two events: the host's
    cost per call, which exceeds a small kernel's device time, stays out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):     # warm-up off the capture: handles, workspaces
        for s in sets:
            fn(*s)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * reps)
