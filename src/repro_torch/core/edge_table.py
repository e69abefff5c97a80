"""Batched open-addressing hash set over directed edges.

Mirrors ``repro.core.edge_table``: linear probing with a bounded walk,
scatter-min slot claims (the lowest op index wins), TOMB logical deletes
and a rehash pass.  Every operation is functional: it returns new column
tensors and never writes into the table it was given, so a committed
snapshot that a reader holds is never touched.

The uint32 hash is computed in int64 masked to 32 bits; torch has no
uint32 multiply or logical shift.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.sync import SYNCS
from repro_torch.kernels.hash_probe import ops as hash_probe

EMPTY = 0
LIVE = 1
TOMB = 2
_M32 = 0xFFFFFFFF


class EdgeTable(NamedTuple):
    src: torch.Tensor  # int32[C]
    dst: torch.Tensor  # int32[C]
    state: torch.Tensor  # int8[C]  EMPTY | LIVE | TOMB


def empty(capacity: int, device) -> EdgeTable:
    if capacity & (capacity - 1):
        raise ValueError("capacity must be a power of two")
    return EdgeTable(
        src=torch.zeros(capacity, dtype=torch.int32, device=device),
        dst=torch.zeros(capacity, dtype=torch.int32, device=device),
        state=torch.zeros(capacity, dtype=torch.int8, device=device))


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow:
    the product is split at 16 bits so no partial product exceeds 2^48."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash(u: torch.Tensor, v: torch.Tensor, capacity: int) -> torch.Tensor:
    """The JAX package's uint32 mixing of (u, v) into [0, capacity)."""
    u = u.long() & _M32
    v = v.long() & _M32
    h = mul32(u, 0x9E3779B1) ^ ((v + 0x85EBCA77 + ((u << 6) & _M32)
                                 + (u >> 2)) & _M32)
    h = h ^ (h >> 15)
    h = mul32(h, 0x2C1B3C6D)
    h = h ^ (h >> 12)
    return (h & (capacity - 1)).int()


def lookup(table: EdgeTable, u, v, max_probes: int, *, impl: str = "auto"
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched membership probe: ``(found: bool[B], slot: int32[B])``;
    ``slot`` is the LIVE slot when found, else the first EMPTY/TOMB slot
    seen, else -1 when the probe bound was exhausted."""
    base = _hash(u, v, table.src.shape[0])
    return hash_probe.probe(table.src, table.dst, table.state, base, u, v,
                            max_probes=max_probes, impl=impl)


def _dedupe(u, v, enable):
    """True for enabled lanes whose key an earlier enabled lane holds:
    a stable lexsort by (u, v), then, in each run of equal keys, every
    enabled lane after the run's first enabled one."""
    order = torch.argsort(v, stable=True)
    order = order[torch.argsort(u[order], stable=True)]
    su, sv, se = u[order], v[order], enable[order]
    start = torch.ones_like(se)
    start[1:] = (su[1:] != su[:-1]) | (sv[1:] != sv[:-1])
    # enabled lanes strictly before each position, and the same count at
    # the start of its run (non-decreasing, so cummax carries it forward)
    before = torch.cumsum(se.long(), 0) - se.long()
    at_start = torch.cummax(torch.where(start, before, 0), 0).values
    dup_sorted = se & (before > at_start)
    dup = torch.empty_like(dup_sorted)
    dup[order] = dup_sorted
    return dup


def insert(table: EdgeTable, u, v, max_probes: int, enable=None, *,
           impl: str = "auto"
           ) -> Tuple[EdgeTable, torch.Tensor, torch.Tensor]:
    """Batched insert.  Returns ``(table, inserted: bool[B], failed:
    bool[B])`` with ``repro.core.edge_table.insert`` semantics: duplicates
    within the batch after the first enabled one, present keys and
    disabled lanes are not inserted; ``failed`` marks lanes that wanted a
    slot but exhausted the probe bound."""
    cap = table.src.shape[0]
    b = u.shape[0]
    dev = u.device
    if enable is None:
        enable = torch.ones(b, dtype=torch.bool, device=dev)
    enable = enable & ~_dedupe(u, v, enable)
    found, _ = lookup(table, u, v, max_probes, impl=impl)
    want = enable & ~found
    base = _hash(u, v, cap)
    lane = torch.arange(b, dtype=torch.int32, device=dev)
    src, dst, state = (table.src.clone(), table.dst.clone(),
                       table.state.clone())
    claims = torch.empty(cap, dtype=torch.int32, device=dev)
    placed = torch.zeros(b, dtype=torch.bool, device=dev)
    probe = torch.zeros(b, dtype=torch.int32, device=dev)
    for _ in range(max_probes):
        pending = want & ~placed
        # a round with no pending lane changes nothing; JAX runs all
        # max_probes rounds, the port stops here
        if not SYNCS.bool(pending.any()):
            break
        pos = ((base + probe) & (cap - 1)).long()
        contend = pending & (state[pos] != LIVE)
        # scatter-min claim over this round's slots: the lowest lane wins
        claims[pos] = b
        claims.scatter_reduce_(0, pos, torch.where(contend, lane, b),
                               reduce="amin")
        owner = claims[pos]
        win = contend & (owner == lane)
        # every lane at a slot writes the slot's winner (or the slot's
        # old value), so duplicate indices write identical values
        claimed = owner < b
        w = owner.clamp(max=b - 1).long()
        src[pos] = torch.where(claimed, u[w], src[pos])
        dst[pos] = torch.where(claimed, v[w], dst[pos])
        state[pos] = torch.where(claimed, LIVE, state[pos]).to(torch.int8)
        placed = placed | win
        probe = torch.where(pending & ~win, probe + 1, probe)
    return EdgeTable(src, dst, state), placed, want & ~placed


def remove(table: EdgeTable, u, v, max_probes: int, enable=None, *,
           impl: str = "auto") -> Tuple[EdgeTable, torch.Tensor]:
    """Batched remove (logical delete -> TOMB).  Returns (table,
    removed[B]); of duplicate removals of one key only the first
    succeeds."""
    b = u.shape[0]
    dev = u.device
    if enable is None:
        enable = torch.ones(b, dtype=torch.bool, device=dev)
    found, slot = lookup(table, u, v, max_probes, impl=impl)
    hit = found & enable
    lane = torch.arange(b, dtype=torch.int32, device=dev)
    pos = torch.where(hit, slot, 0).long()
    claims = torch.empty(table.src.shape[0], dtype=torch.int32, device=dev)
    claims[pos] = b
    claims.scatter_reduce_(0, pos, torch.where(hit, lane, b), reduce="amin")
    owner = claims[pos]
    first = hit & (owner == lane)
    state = table.state.clone()
    state[pos] = torch.where(owner < b, TOMB, state[pos]).to(torch.int8)
    return table._replace(state=state), first


def remove_incident(table: EdgeTable, v_mask: torch.Tensor
                    ) -> Tuple[EdgeTable, torch.Tensor]:
    """Tombstone every LIVE edge with an endpoint in ``v_mask``."""
    live = table.state == LIVE
    kill = live & (v_mask[table.src] | v_mask[table.dst])
    state = torch.where(kill, TOMB, table.state).to(torch.int8)
    return table._replace(state=state), kill


def rehash(table: EdgeTable, new_capacity: int, max_probes: int, *,
           impl: str = "auto") -> EdgeTable:
    """Migrate every LIVE entry into a fresh table of ``new_capacity``
    (tombstones dropped; ``rehash(t, cap(t))`` is :func:`compact`)."""
    if new_capacity & (new_capacity - 1):
        raise ValueError("new_capacity must be a power of two")
    fresh = empty(new_capacity, table.src.device)
    fresh, _, _ = insert(fresh, table.src, table.dst, max_probes,
                         enable=table.state == LIVE, impl=impl)
    return fresh


def compact(table: EdgeTable, max_probes: int, *, impl: str = "auto"
            ) -> EdgeTable:
    return rehash(table, table.src.shape[0], max_probes, impl=impl)


def fill_stats(table: EdgeTable):
    """(live, tomb) slot counts as int32 scalars on the table's device."""
    return ((table.state == LIVE).sum().int(),
            (table.state == TOMB).sum().int())
