"""CUDA-graph capture shared by the step runners, flow training and the
Stan solvers.

``capture(fn, device, graph=None, pool=None)`` runs ``fn()`` under capture
into ``graph`` (a new ``torch.cuda.CUDAGraph`` where none is given) on a
side stream, so its work is queued, not run, and returns ``fn``'s result;
the caller replays the graph on the current stream.  The capture is
thread-local: CUDA work of another thread (the caller of a non-blocking
``sample()``) neither breaks nor joins it.  The garbage collector does not
run during a capture: a graph it freed then (one held in a reference
cycle) would invalidate the capture.
"""

from __future__ import annotations

import gc

import torch


def capture(fn, device, graph=None, pool=None):
    """``(graph, fn())`` with ``fn``'s CUDA work captured in ``graph``."""
    device = torch.device(device)
    graph = torch.cuda.CUDAGraph() if graph is None else graph
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.device(device), torch.cuda.stream(side):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = fn()
            finally:
                graph.capture_end()
    finally:
        if collecting:
            gc.enable()
    current.wait_stream(side)
    return graph, out
