"""Device time of a kernel call, and the kernels a call launches, for the
chip smoke script, the GPU tests and the tools.

Imports ``torch`` only; needs a CUDA device when called.
"""
from __future__ import annotations

import ctypes

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


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` of ``cuda.h`` (libcuda's graph API)."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def graph_kernels(fn, *args):
    """The kernels one ``fn(*args)`` call launches, read from the kernel
    nodes of a CUDA graph captured around that call (after one warm-up
    call): a list of (mangled name, grid, block) in the graph's node order.
    A count that does not rest on the profiler, whose tracer can drop
    records. Reads the graph through ``libcuda.so.1`` (``cuGraphGetNodes``
    and its kin); raises if that library lacks a function it needs."""
    fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn(*args)
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())

    def ok(rc, what):
        if rc != 0:
            raise RuntimeError(f"graph_kernels: {what} returned CUresult {rc}")
    n = ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    ok(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    out = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        ok(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != 0:   # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        p = _KernelNodeParams()
        ok(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(p)),
           "cuGraphKernelNodeGetParams_v2")
        name = ctypes.c_char_p()
        if p.func:
            ok(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func)), "cuFuncGetName")
        else:
            ok(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(p.kern)),
               "cuKernelGetName")
        out.append((name.value.decode(), tuple(p.grid), tuple(p.block)))
    del graph
    return out
