"""Dynamic SCC-Graph state as a NamedTuple of tensors.

Mirrors ``repro.core.graph_state``: vertices are slots ``0..n_vertices-1``
with a ``v_alive`` mask, edges live in the open-addressing table of
:mod:`repro_torch.core.edge_table`, and ``ccid[v]`` is the minimum vertex
id of v's SCC (``n_vertices`` for dead slots).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import edge_table as et

INT32_MAX = 2 ** 31 - 1
DEFAULT_DEVICE = "cuda"

# Repair-tier codes reported in RepairStats.tier (same codes as the JAX
# package): the smallest tier the affected region fits runs, and TIER_SKIP
# records that the repair gate proved the region empty.
TIER_DENSE = 0
TIER_COMPACT = 1
TIER_FULL = 2
TIER_SKIP = 3
TIER_NAMES = ("dense", "compact", "full", "skipped")


class RepairStats(NamedTuple):
    """Per-step repair telemetry: int32 tensors on the state's device (0-d
    a step, [K] from the scan entry, [T] / [T, K] over tenant lanes), read
    back with the step's other outputs."""
    tier: int
    region_vertices: int
    region_edges: int


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Static capacities of the dynamic graph; the fields and defaults of
    ``repro.core.graph_state.GraphConfig``, so a config carries across.

    ``dense_matmul_impl`` and ``sparse_impl`` are kept for that reason
    only: the port picks the plain version for CPU tensors and the CUDA
    kernel for CUDA tensors, and a plain impl ('xla', 'pallas_interpret')
    asked for on CUDA tensors raises.  ``label_spec`` pins the label
    arrays' sharding inside the fixpoints (``sharding.constrain``).
    """

    n_vertices: int
    edge_capacity: int
    max_probes: int = 64
    max_outer: int = 128
    max_inner: int = 256
    dense_capacity: int = 0
    dense_matmul_impl: str = "auto"
    sparse_impl: str = "auto"
    region_vertex_capacity: int = 0
    region_edge_buckets: tuple = (256, 4096, 65536)
    label_spec: object = None
    fuse_fwbw: bool = False
    shortcut: bool = False
    repair_gate: bool = True

    def __post_init__(self):
        if self.edge_capacity & (self.edge_capacity - 1):
            raise ValueError("edge_capacity must be a power of two")
        object.__setattr__(self, "region_edge_buckets",
                           tuple(sorted(set(int(b) for b in
                                            self.region_edge_buckets))))
        if not all(b > 0 for b in self.region_edge_buckets):
            raise ValueError("region_edge_buckets must be positive")
        if self.region_vertex_capacity < 0:
            raise ValueError("region_vertex_capacity must be >= 0")
        for name in ("sparse_impl", "dense_matmul_impl"):
            if getattr(self, name) not in ("auto", "pallas",
                                           "pallas_interpret", "xla"):
                raise ValueError(f"{name}={getattr(self, name)!r}")


class GraphState(NamedTuple):
    """The dynamic SCC-Graph; all tensors on one device."""

    v_alive: torch.Tensor  # bool[NV]
    ccid: torch.Tensor  # int32[NV]  min id in SCC; NV if dead
    edges: et.EdgeTable
    n_ccs: torch.Tensor  # int32[]
    gen: torch.Tensor  # int32[]  bumped by every step
    overflow: torch.Tensor  # int32[]  table-op failures (host must grow)

    @property
    def device(self) -> torch.device:
        return self.v_alive.device


def _scalar(x: int, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.int32, device=device)


def empty(cfg: GraphConfig, device=DEFAULT_DEVICE) -> GraphState:
    nv = cfg.n_vertices
    return GraphState(
        v_alive=torch.zeros(nv, dtype=torch.bool, device=device),
        ccid=torch.full((nv,), nv, dtype=torch.int32, device=device),
        edges=et.empty(cfg.edge_capacity, device),
        n_ccs=_scalar(0, device), gen=_scalar(0, device),
        overflow=_scalar(0, device))


def from_arrays(cfg: GraphConfig, src, dst, n_active_vertices=None,
                device=DEFAULT_DEVICE) -> GraphState:
    """Bulk-load a static graph.  ``ccid`` is not computed here; call
    :func:`repro_torch.core.dynamic.recompute` on the result."""
    src = torch.as_tensor(src, dtype=torch.int32).to(device)
    dst = torch.as_tensor(dst, dtype=torch.int32).to(device)
    state = empty(cfg, device)
    nv = cfg.n_vertices
    if n_active_vertices is None:
        n_active_vertices = nv
    v_alive = torch.arange(nv, device=device) < n_active_vertices
    table, _, failed = et.insert(state.edges, src, dst, cfg.max_probes,
                                 impl=cfg.sparse_impl)
    return state._replace(v_alive=v_alive, edges=table,
                          overflow=state.overflow + failed.sum().int())


def all_singletons(cfg: GraphConfig, device=DEFAULT_DEVICE) -> GraphState:
    """Every vertex slot live, each its own SCC, no edges."""
    nv = cfg.n_vertices
    return recount_ccs(empty(cfg, device)._replace(
        v_alive=torch.ones(nv, dtype=torch.bool, device=device),
        ccid=torch.arange(nv, dtype=torch.int32, device=device)))


def edge_coo(state: GraphState):
    """(src, dst, live_mask) view of the edge table."""
    t = state.edges
    return t.src, t.dst, t.state == et.LIVE


def live_edge_count(state: GraphState) -> torch.Tensor:
    return (state.edges.state == et.LIVE).sum().int()


def live_vertex_count(state: GraphState) -> torch.Tensor:
    return state.v_alive.sum().int()


def recount_ccs(state: GraphState) -> GraphState:
    """n_ccs = #representatives (v alive with ccid[v] == v); per lane for
    stacked lanes."""
    nv = state.ccid.shape[-1]
    vid = torch.arange(nv, dtype=torch.int32, device=state.ccid.device)
    reps = state.v_alive & (state.ccid == vid)
    return state._replace(n_ccs=reps.sum(-1).int())


# ---------------------------------------------------------------------------
# Stacked tenant lanes: every leaf gains a leading [T] axis (v_alive and
# ccid [T, NV], the edge columns [T, C], n_ccs / gen / overflow [T]).  The
# JAX package stacks pytrees for jax.vmap; these are its _stack / _lane /
# _set_lane and the whole-batch gather and scatter of its tenancy engine.
# ---------------------------------------------------------------------------

def _map(fn, *trees):
    first = trees[0]
    if isinstance(first, tuple):  # GraphState / EdgeTable
        return type(first)(*(_map(fn, *leaves) for leaves in zip(*trees)))
    return fn(*trees)


def stack(states) -> GraphState:
    """Stack same-config states along a new leading lane axis."""
    return _map(lambda *xs: torch.stack(xs), *states)


def lane(states: GraphState, i: int) -> GraphState:
    """Lane ``i`` of stacked lanes, as a state of its own (a copy)."""
    return _map(lambda a: a[i].clone(), states)


def take_lanes(states: GraphState, idx) -> GraphState:
    """Lanes ``idx`` (a list or an index tensor) of stacked lanes, in that
    order."""
    idx = torch.as_tensor(idx, dtype=torch.long).to(states.device)
    return _map(lambda a: a.index_select(0, idx), states)


def set_lanes(states: GraphState, idx, sub: GraphState) -> GraphState:
    """New stacked lanes with lanes ``idx`` replaced by the lanes of
    ``sub`` (functional: ``states`` is not written)."""
    idx = torch.as_tensor(idx, dtype=torch.long).to(states.device)
    return _map(lambda a, x: a.index_copy(0, idx, x), states, sub)


def concat_lanes(states: GraphState, more: GraphState) -> GraphState:
    """Stacked lanes followed by the lanes of ``more``."""
    return _map(lambda a, x: torch.cat([a, x]), states, more)
