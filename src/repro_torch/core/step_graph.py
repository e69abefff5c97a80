"""The SMSCC update step as one replay of a captured CUDA graph.

The JAX package compiles its step once per (K, bucket, cfg) and runs a
super-chunk as one program (``lax.scan``) with one deferred host transfer
(``src/repro/core/dynamic.py:373-400``).  On the card the port captures the
step (``dynamic._step``) once per (cfg, bucket B, card) into a CUDA graph
and replays it:

- the step reads its state from the graph's own input buffers and its ops
  from a ring of :data:`RING` rows at a slot held on the card;
- the repair gate and every repair tier are IF nodes
  (``kernels/graph_cond``), so the branch is decided on the card as the
  reference's ``lax.cond`` / ``lax.switch`` decide it;
- every fixpoint, and the static SCC with its outer loop, is one kernel
  launch;
- the step ends by writing the new state back into the input buffers, its
  ok, overflow and repair stats into the slot's result row, and moving the
  slot on.

:func:`run` takes a super-chunk of K steps: it copies the entry state in
once, replays K times and clones the state and the result rows out.  The
graph's buffers are never handed out, so a snapshot a reader holds is
never written by a later replay.  Nothing is read back to the host.

Tenant lanes (``dynamic._step_lanes``, the reference's ``jax.vmap`` of
its scan): the state's leaves and the op ring gain a lane axis ([RING, 3,
T, B] ops, [RING, T, B + 4] result rows), and a graph is captured once per
(cfg, bucket, lane count T, card).  A dispatch of n <= T lanes copies its
n states into the first rows and steps NOP ops in the rest, whose states
(left by earlier replays) it never reads back.

Capture: a throwaway capture in relaxed mode first, which loads every
kernel the branches launch (as PyTorch's own cond warm-up does), then the
real one in thread-local mode, one capture at a time, so other threads'
reads and launches go on beside it.  A dropped graph's branch pool is
freed under the capture lock too (freeing a pool empties it, which the
allocator refuses while any thread captures): at the next capture or
:func:`clear`.  A device-wide wait is refused while
any stream on the card captures, whichever thread began the capture, so
the port waits for the card through :func:`synchronize`, which waits for a
capture under way to end.  A capture runs on streams of its own
(``graph_cond.own_stream``): PyTorch's pooled streams are handed to other
code too, and a pooled stream that is already capturing cannot take a
branch.  What the capturing
thread allocates comes from the graph's private pool (on the capture
stream) or from a pool the graph keeps for its branches (on their
streams).  A capture, build or launch failure raises;
nothing falls back to the eager step.  A grow or rehash that changes the
cfg captures a new graph; :data:`MAX_GRAPHS` are kept.  :func:`capture`
is that discipline for any body: the LM server's decode graph
(``launch/serve.py``) is captured through it too.

Launch counts: a capture launches nothing, so each wrapper's counts during
a capture go to the capture's recorder, one region for the step's
unconditional part and one for each branch.  Every replay adds one to the
device counter of each region it ran, and :meth:`StepGraph.flush` (called
by ``kernels.launch_counts``) adds runs x launches to the wrappers'
counters.
"""
from __future__ import annotations

import collections
import threading
import time
import weakref

import torch

from repro_torch import trace
from repro_torch.core import graph_state as gs
from repro_torch.kernels import _build
from repro_torch.kernels import graph_cond

RING = 16  # steps a graph's op and result rings hold between copies
MAX_GRAPHS = 8
MAX_REGIONS = 64  # the step's unconditional part and its branches
# capture under torch.cuda.set_sync_debug_mode("error"), so a read back
# inside the step raises (process-wide: for runs without other threads)
SYNC_DEBUG = False

captures = 0  # graphs captured (the reference's compiles)
capture_s = 0.0  # seconds spent capturing them
_cache: "collections.OrderedDict" = collections.OrderedDict()
_cache_lock = threading.Lock()
_capture_lock = threading.Lock()
# (card, role) -> a stream only captures use: "capture", or a branch's
# nesting depth
_streams: dict = {}
# the branch pools of graphs that are gone: freeing a pool empties it,
# which the allocator refuses while any thread captures, so they are
# freed under the capture lock (:func:`_free_dead_pools`)
_dead_pools: list = []


def _stream(device, role):
    key = (device.index, role)
    s = _streams.get(key)
    if s is None:
        s = _streams[key] = graph_cond.own_stream(device)
    return s


def synchronize(device) -> None:
    """``torch.cuda.synchronize(device)`` that never overlaps a step
    graph's capture in another thread (the card refuses a device-wide wait
    while a stream captures, and the capture is lost with it).  No-op for
    a CPU device."""
    device = torch.device(device)
    if device.type == "cuda":
        with _capture_lock:
            torch.cuda.synchronize(device)


def graphable(state: gs.GraphState) -> bool:
    """Whether the step of ``state`` runs as a graph: plain CUDA tensors
    (a DTensor or a CPU state steps eagerly)."""
    x = state.v_alive
    return type(x) is torch.Tensor and x.is_cuda


def _leaves(state: gs.GraphState) -> list:
    return [state.v_alive, state.ccid, *state.edges, state.n_ccs, state.gen,
            state.overflow]


class _Recorder:
    """The launches of one capture by region (0: the step's unconditional
    part, then one per IF node body); ``runs[r]`` counts on the card the
    replays that ran region r."""

    def __init__(self, device):
        self.runs = torch.zeros(MAX_REGIONS, dtype=torch.int64,
                                device=device)
        self.launches = [collections.Counter()]
        self.stack = [0]

    def add(self, fn, attrs) -> None:
        for a in attrs:
            self.launches[self.stack[-1]][(fn, a)] += 1

    def enter(self) -> None:
        """Open the region of the body being captured: its first work is
        the +1 on its run counter."""
        r = len(self.launches)
        if r >= MAX_REGIONS:
            raise RuntimeError(f"a step graph holds at most {MAX_REGIONS} "
                               "branches")
        self.launches.append(collections.Counter())
        self.stack.append(r)
        self.runs[r:r + 1].add_(1)


class _Capture:
    """What a captured body (``dynamic._step``, ``dynamic._step_lanes``,
    the decode step) is handed: ``cond`` captures a function as a branch
    decided on the card."""

    def __init__(self, device, rec: _Recorder):
        self.device = device
        self.rec = rec
        self.depth = 0

    def cond(self, pred: torch.Tensor, body) -> None:
        """``body()`` captured into an IF node: each replay runs it only
        where the bool scalar ``pred`` holds."""
        stream = _stream(self.device, self.depth)
        self.depth += 1
        try:
            with graph_cond.if_node(pred, stream):
                self.rec.enter()
                try:
                    body()
                finally:
                    self.rec.stack.pop()
        finally:
            self.depth -= 1


def _prepare(device) -> None:
    """What must not happen inside a capture: build and load every kernel
    the step can launch, and make the card's fixpoint round counter."""
    from repro_torch.kernels.frontier_expand import ops as fops
    for name in ("frontier_min", "hash_probe", "bool_matmul", "graph_cond"):
        _build.load(name)
    fops._tally(device)


def _free_dead_pools() -> None:
    """Free the branch pools of dropped graphs; the caller holds the
    capture lock."""
    while _dead_pools:
        _dead_pools.pop()


def capture(device, body):
    """Capture ``body(cap)`` (``cap``: a :class:`_Capture`) into a CUDA
    graph on ``device``: a throwaway capture in relaxed mode, then the
    real one in thread-local mode, under the capture lock, on the port's
    own capture stream, the body's branch allocations in a pool the graph
    keeps and its kernel launches recorded by region.  Returns ``(graph,
    recorder, pool)``; a failure raises."""
    with trace.span("step.capture"), _capture_lock:
        _free_dead_pools()
        for mode in ("relaxed", "thread_local"):
            graph = torch.cuda.CUDAGraph()
            rec = _Recorder(device)
            side = _stream(device, "capture")
            side.wait_stream(torch.cuda.current_stream(device))
            # the branches' allocations: a pool of their own (the graph's
            # pool already takes the capture stream's)
            bodies = torch.cuda.MemPool()
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode=mode):
                torch._C._cuda_beginAllocateCurrentThreadToPool(
                    device.index, bodies.id)
                _build.set_recorder(rec)
                debug = SYNC_DEBUG and mode == "thread_local"
                prev = torch.cuda.get_sync_debug_mode()
                if debug:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    rec.runs[0:1].add_(1)  # a replay ran the body
                    body(_Capture(device, rec))
                finally:
                    if debug:
                        torch.cuda.set_sync_debug_mode(prev)
                    _build.set_recorder(None)
                    # as ``torch.cuda.use_mem_pool`` does: the MemPool
                    # object now holds the pool alone, so its memory goes
                    # back to the card once the graph drops it
                    torch._C._cuda_endAllocateToPool(device.index,
                                                     bodies.id)
                    torch._C._cuda_releasePool(device.index, bodies.id)
            if mode == "relaxed":
                graph.reset()
                _dead_pools.append(bodies)
        _free_dead_pools()
    return graph, rec, bodies


class Captured:
    """A graph made by :func:`capture`, its replays' launches added to
    the wrappers' counters on :meth:`flush` (``kernels.launch_counts``).
    ``lock`` and ``done`` order its users: a user takes the lock, waits
    for ``done`` on its stream, writes the inputs, replays, reads the
    outputs, and records ``done``."""

    def __init__(self, device, body):
        self.device = device
        self.lock = threading.Lock()
        self.done = torch.cuda.Event()
        self.graph, self.rec, self.bodies = capture(device, body)
        # the graph goes with this object; its branch pool waits for the
        # capture lock
        weakref.finalize(self, _dead_pools.append, self.bodies)
        _build.track_graph(self)

    def flush(self) -> None:
        """Add the launches of the replays since the last flush to the
        wrappers' counters (one read of the region counters)."""
        with self.lock:
            torch.cuda.current_stream(self.device).wait_event(self.done)
            runs = self.rec.runs.tolist()
            self.rec.runs.zero_()
        for n_runs, counts in zip(runs, self.rec.launches):
            for (fn, attr), n in counts.items():
                setattr(fn, attr, getattr(fn, attr) + n * n_runs)


def _padded(x: torch.Tensor, lanes) -> torch.Tensor:
    """A contiguous copy of ``x``, its lane axis filled up to ``lanes``
    with copies of lane 0 (any valid state: those lanes step NOPs)."""
    x = x.clone(memory_format=torch.contiguous_format)
    if lanes is None or x.shape[0] == lanes:
        return x
    return torch.cat([x, x[:1].expand(lanes - x.shape[0], *x.shape[1:])])


class StepGraph(Captured):
    """The captured step of one (cfg, bucket ``b``, lane count, card);
    ``lanes`` None for a single graph's step."""

    def __init__(self, state: gs.GraphState, cfg: gs.GraphConfig, b: int,
                 step, lanes: int | None = None):
        global captures, capture_s
        t0 = time.perf_counter()
        dev = state.device
        lead = () if lanes is None else (lanes,)
        self.inp = gs._map(lambda x: _padded(x, lanes), state)
        self.ops = torch.zeros((RING, 3, *lead, b), dtype=torch.int32,
                               device=dev)
        self.slot = torch.zeros(1, dtype=torch.int64, device=dev)
        self.rows = torch.zeros((RING, *lead, b + 4), dtype=torch.int32,
                                device=dev)
        _prepare(dev)
        super().__init__(dev, lambda cap: self._body(cfg, step, cap))
        captures += 1
        capture_s += time.perf_counter() - t0

    def _body(self, cfg, step, cap: _Capture) -> None:
        row = self.ops.index_select(0, self.slot)[0]
        new, ok, ovf, stats = step(self.inp, (row[0], row[1], row[2]), cfg,
                                   cap)
        packed = torch.cat([ok.int(), ovf.unsqueeze(-1), stats], -1)
        self.rows.index_copy_(0, self.slot, packed.unsqueeze(0))
        for d, s in zip(_leaves(self.inp), _leaves(new)):
            d.copy_(s)
        self.slot.add_(1)


def _graph(state, cfg, b, step, lanes) -> StepGraph:
    key = (cfg, b, lanes, state.device)
    with _cache_lock:
        g = _cache.get(key)
        if g is not None:
            _cache.move_to_end(key)
            return g
    g = StepGraph(state, cfg, b, step, lanes)
    with _cache_lock:
        _cache[key] = g
        while len(_cache) > MAX_GRAPHS:
            _cache.popitem(last=False)[1].flush()
    return g


def run(state: gs.GraphState, ops, cfg: gs.GraphConfig, step):
    """K steps of ``ops`` (kind, u, v: int32 [K, B], on the host or the
    card) from ``state`` through the step graph of (cfg, B, card): returns
    ``(new_state, ok bool[K, B], ovf int32[K], stats int32[K, 3])``, new
    tensors on the card.  ``state`` is only read.

    Tenant lanes: ``state`` with [n, ...] leaves and ``ops`` [T, K, B]
    with T >= n (rows past n are NOP rows) run through the lane graph of
    (cfg, B, T, card); returns ``(new_state, ok bool[n, K, B], ovf
    int32[n, K], stats int32[n, K, 3])``."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("the step graph replays; it cannot be captured "
                           "into another graph")
    dev = state.device
    lanes = state.v_alive.dim() == 2
    stacked = torch.stack([torch.as_tensor(x, dtype=torch.int32)
                           for x in ops], -2)
    if lanes:  # [T, K, 3, B] -> [K, 3, T, B]
        n, t_n = state.v_alive.shape[0], stacked.shape[0]
        stacked = stacked.permute(1, 2, 0, 3).contiguous()
    k, b = stacked.shape[0], stacked.shape[-1]
    if stacked.device.type == "cpu":  # no host wait behind queued steps
        stacked = stacked.pin_memory().to(dev, non_blocking=True)
    g = _graph(state, cfg, b, step, t_n if lanes else None)

    def mine(x):  # the caller's lanes of a graph buffer
        return x[:n] if lanes else x
    outs = []
    with g.lock:
        stream = torch.cuda.current_stream(dev)
        stream.wait_event(g.done)
        for d, s in zip(_leaves(g.inp), _leaves(state)):
            mine(d).copy_(s)
        for k0 in range(0, k, RING):
            kk = min(RING, k - k0)
            g.ops[:kk].copy_(stacked[k0:k0 + kk])
            g.slot.zero_()
            for _ in range(kk):
                g.graph.replay()
            outs.append((g.rows[:kk, :n] if lanes else g.rows[:kk]).clone())
        new = gs._map(lambda x: mine(x).clone(), g.inp)
        g.done.record(stream)
    rows = outs[0] if len(outs) == 1 else torch.cat(outs)
    if lanes:  # [K, n, B + 4] -> [n, K, B + 4]
        rows = rows.transpose(0, 1)
    return new, rows[..., :b].bool(), rows[..., b], rows[..., b + 1:]


def clear() -> None:
    """Drop every captured step graph (their launches counted first) and
    free the branch pools of the graphs that are gone; the next step on
    the card captures anew."""
    with _cache_lock:
        graphs = list(_cache.values())
        _cache.clear()
    while graphs:
        graphs.pop().flush()
    with _capture_lock:
        _free_dead_pools()


def stats() -> dict:
    return {"step_graph_captures": captures, "capture_s": capture_s}
