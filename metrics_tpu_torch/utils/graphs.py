"""CUDA-graph capture shared by the serving engine and ``jitted_update_state``."""

from __future__ import annotations

import contextlib
import gc
import threading
import warnings
from typing import Any, Callable, Iterator, Optional, Tuple

import torch

# captures in flight on any thread, and whether the collector was on before the first
_collector_lock = threading.Lock()
_collector_pauses = 0
_collector_was_enabled = False


@contextlib.contextmanager
def collector_paused() -> Iterator[None]:
    """Python's cyclic garbage collector off for the block, process-wide.

    Nested and concurrent blocks (two engines capturing on two threads) share
    one pause: the first to enter turns the collector off, the last to leave
    turns it back on if it was on before the first, so one capture's end never
    turns it on under another capture.
    """
    global _collector_pauses, _collector_was_enabled
    with _collector_lock:
        if _collector_pauses == 0:
            _collector_was_enabled = gc.isenabled()
            gc.disable()
        _collector_pauses += 1
    try:
        yield
    finally:
        with _collector_lock:
            _collector_pauses -= 1
            if _collector_pauses == 0 and _collector_was_enabled:
                gc.enable()


def capture(fn: Callable[[], Any], stream: torch.cuda.Stream, pool: Optional[Any] = None) -> Tuple[torch.cuda.CUDAGraph, Any]:
    """``fn()`` captured on ``stream`` (into ``pool`` when given): ``(graph, fn's result)``.

    The graph keeps its ``cudaGraph_t`` (``keep_graph=True``), so a caller can
    inspect it through ``raw_cuda_graph()``; that costs host memory only. The
    capture mode is ``thread_local``, and the capture begins as
    ``torch.cuda.graph``'s entry begins one, less its device-wide sync: on one
    card shared by several engines (a sharded engine's shards, each capturing
    on its own dispatcher thread) a device-wide sync while another thread
    captures invalidates that capture, so only ``stream`` is synchronized.
    The device and host caching allocators are emptied as there: that also
    releases the graph pools whose graphs were all dropped (an engine's graphs
    at a capacity it grew out of), and a capture into such a pool's handle
    before its release trips the allocator's use-count assertion.

    A capture that fails (a host read inside ``fn``, say) re-raises its error.
    PyTorch then leaves its default CUDA generator marked as capturing (the end
    of the capture raised before the generator's epilogue ran), and every later
    random operation would fail; one empty capture runs that epilogue again.

    Python's cyclic garbage collector is off while ``fn`` is captured
    (:func:`collector_paused`): a collection inside the capture could free an
    unreachable engine's graph on this thread, and destroying a graph is not
    permitted while the thread captures.
    """
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with collector_paused():
        stream.synchronize()
        torch.cuda.empty_cache()
        torch._C._host_emptyCache()
        try:
            out = _captured(graph, fn, stream, pool)
        except Exception:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # "the CUDA graph is empty"
                _captured(torch.cuda.CUDAGraph(), lambda: None, stream, None)
            raise
    return graph, out


def _captured(graph: torch.cuda.CUDAGraph, fn: Callable[[], Any], stream: torch.cuda.Stream, pool: Optional[Any]) -> Any:
    """``fn()`` between ``capture_begin`` and ``capture_end`` on ``stream``. An
    error in ``fn`` still ends the capture (whose own error, on an invalidated
    capture, is dropped for ``fn``'s)."""
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = fn()
        except Exception:
            try:
                graph.capture_end()
            except Exception:  # noqa: BLE001 — the capture is invalid either way; fn's error is the cause
                pass
            raise
        graph.capture_end()
    return out
