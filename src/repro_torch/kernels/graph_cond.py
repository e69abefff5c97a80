"""IF nodes inside a CUDA graph capture: ``csrc/graph_cond.cu``.

The port's step graph (``core/step_graph.py``) takes the JAX step's
``lax.cond`` branches (the repair gate, the repair tier) as conditional
nodes, decided on the card on every replay.  :func:`if_node` captures a
block of work into one: on a replay the block runs only where a CUDA bool
scalar holds.  It has no plain version to fall back to; outside a capture
(and on the CPU) the step reads the predicate back instead, which is the
plain version of the decision.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from repro_torch.kernels import _build


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("graph_cond")
    lib.graph_if_begin.argtypes = [ctypes.c_void_p] * 3
    lib.graph_if_end.argtypes = [ctypes.c_void_p]
    lib.graph_stream_create.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
    for fn in (lib.graph_if_begin, lib.graph_if_end,
               lib.graph_stream_create):
        fn.restype = ctypes.c_int
    return lib


def own_stream(device) -> torch.cuda.ExternalStream:
    """A non-blocking stream on ``device`` that no one else is handed (a
    PyTorch stream comes from a pool of 32 that other code shares)."""
    ptr = ctypes.c_void_p()
    with torch.cuda.device(device):
        _build.check(_lib().graph_stream_create(ctypes.byref(ptr)),
                     "graph_stream_create")
    return torch.cuda.ExternalStream(ptr.value, device=device)


@contextlib.contextmanager
def if_node(pred: torch.Tensor, body: torch.cuda.Stream):
    """Capture the block, issued on the current stream, into an IF node of
    the graph that stream is capturing: each replay runs it only where
    ``pred`` (a bool scalar on the card) is true when the replay reaches
    the node.  The block is captured on ``body``, a stream of its own that
    is the current stream inside the block; work issued after the block
    runs after the node.  Raises if the stream is not capturing."""
    if pred.dtype != torch.bool or pred.numel() != 1 or not pred.is_cuda:
        raise ValueError("an IF node takes a bool scalar on the card, got "
                         f"{pred.dtype} {tuple(pred.shape)} on "
                         f"{pred.device}")
    outer = torch.cuda.current_stream(pred.device)
    _build.check(_lib().graph_if_begin(outer.cuda_stream, pred.data_ptr(),
                                       body.cuda_stream), "graph_if_begin")
    try:
        with torch.cuda.stream(body):
            yield
    finally:
        _build.check(_lib().graph_if_end(body.cuda_stream), "graph_if_end")
