"""CUDA-graph capture shared by the serving engine and ``jitted_update_state``."""

from __future__ import annotations

import warnings
from typing import Any, Callable, Optional, Tuple

import torch


def capture(fn: Callable[[], Any], stream: torch.cuda.Stream, pool: Optional[Any] = None) -> Tuple[torch.cuda.CUDAGraph, Any]:
    """``fn()`` captured on ``stream`` (into ``pool`` when given): ``(graph, fn's result)``.

    The graph keeps its ``cudaGraph_t`` (``keep_graph=True``), so a caller can
    inspect it through ``raw_cuda_graph()``; that costs host memory only. The
    capture mode is ``thread_local``: other threads may go on using the card.

    A capture that fails (a host read inside ``fn``, say) re-raises its error.
    PyTorch then leaves its default CUDA generator marked as capturing (the end
    of the capture raised before the generator's epilogue ran), and every later
    random operation would fail; one empty capture runs that epilogue again.
    """
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
            out = fn()
    except Exception:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # "the CUDA graph is empty"
            with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=stream, capture_error_mode="thread_local"):
                pass
        raise
    return graph, out
