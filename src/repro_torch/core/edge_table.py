"""Batched open-addressing hash set over directed edges.

Mirrors ``repro.core.edge_table``: linear probing with a bounded walk,
scatter-min slot claims (the lowest op index wins), TOMB logical deletes
and a rehash pass.  Every operation is functional: it returns new column
tensors and never writes into the table it was given, so a committed
snapshot that a reader holds is never touched.

On the card the hash, the walk and the claim rounds of ``insert`` and
``remove`` run in one kernel launch each (``kernels/hash_probe``); the
batch's dedupe stays here.  The hash's torch form
(``kernels/hash_probe/ref.hash_slots``) computes the uint32 mix in int64
masked to 32 bits; torch has no uint32 multiply or logical shift.

Tenant lanes: a table with [T, C] columns is T tenants' tables in one
allocation, each row exactly its solo layout.  ``lookup``, ``insert``,
``remove``, ``remove_incident`` and ``fill_stats`` take it with [T, B]
keys (and [T, NV] vertex masks): row t's keys act on row t only, in one
kernel launch for all rows, and an insert's duplicates are found per
(row, u, v).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels.hash_probe import ops as hash_probe
from repro_torch.kernels.hash_probe.ref import hash_slots as _hash

EMPTY = 0
LIVE = 1
TOMB = 2


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


def lookup(table: EdgeTable, u, v, max_probes: int, *, impl: str = "auto"
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched membership probe: ``(found: bool[B], slot: int32[B])``;
    ``slot`` is the LIVE slot when found, else the first EMPTY/TOMB slot
    seen, else -1 when the probe bound was exhausted."""
    base = _hash(u, v, table.src.shape[-1])
    return hash_probe.probe(table.src, table.dst, table.state, base, u, v,
                            max_probes=max_probes, impl=impl)


def _dedupe(u, v, enable):
    """True for enabled lanes whose key an earlier enabled lane holds.  A
    stable sort by (u, v), enabled lanes first within each key, puts a
    key's first enabled lane at the start of its run, so every enabled
    lane past a run's start is a duplicate.  (No scan and no scatter: a
    cummax or a scatter-min over run ids is slow on the card.)  [T, B]
    lanes are keyed on (row, u, v): duplicates only within a row."""
    shape = u.shape
    keys = (u, v)
    if u.dim() == 2:
        row = torch.arange(shape[0], dtype=torch.int32, device=u.device)
        keys = (row[:, None].expand(shape).reshape(-1), u.reshape(-1),
                v.reshape(-1))
        enable = enable.reshape(-1)
    order = torch.argsort((~enable).to(torch.uint8), stable=True)
    for key in reversed(keys):
        order = order[torch.argsort(key[order], stable=True)]
    sorted_keys = [key[order] for key in keys]
    se = enable[order]
    start = torch.ones_like(se)
    start[1:] = sorted_keys[0][1:] != sorted_keys[0][:-1]
    for sk in sorted_keys[1:]:
        start[1:] |= sk[1:] != sk[:-1]
    dup = torch.empty_like(se)
    dup[order] = se & ~start
    return dup.reshape(shape)


def insert(table: EdgeTable, u, v, max_probes: int, enable=None, *,
           impl: str = "auto"
           ) -> Tuple[EdgeTable, torch.Tensor, torch.Tensor]:
    """Batched insert.  Returns ``(table, inserted: bool[B], failed:
    bool[B])`` with ``repro.core.edge_table.insert`` semantics: duplicates
    within the batch after the first enabled one, present keys and
    disabled lanes are not inserted; ``failed`` marks lanes that wanted a
    slot but exhausted the probe bound.  The hash, the lookup and every
    claim round run in ``hash_probe.insert`` (on the card: one launch, no
    host read), writing into clones of the columns."""
    if enable is None:
        enable = torch.ones(u.shape, dtype=torch.bool, device=u.device)
    enable = enable & ~_dedupe(u, v, enable)
    src, dst, state = (table.src.clone(), table.dst.clone(),
                       table.state.clone())
    placed, failed, _ = hash_probe.insert(src, dst, state, u, v, enable,
                                          max_probes=max_probes, impl=impl)
    return EdgeTable(src, dst, state), placed, failed


def remove(table: EdgeTable, u, v, max_probes: int, enable=None, *,
           impl: str = "auto") -> Tuple[EdgeTable, torch.Tensor]:
    """Batched remove (logical delete -> TOMB).  Returns (table,
    removed[B]); of duplicate removals of one key only the first
    succeeds.  The hash, the walk, the claim and the TOMB write run in
    ``hash_probe.remove``, writing into a clone of ``state``."""
    if enable is None:
        enable = torch.ones(u.shape, dtype=torch.bool, device=u.device)
    state = table.state.clone()
    removed = hash_probe.remove(table.src, table.dst, state, u, v, enable,
                                max_probes=max_probes, impl=impl)
    return table._replace(state=state), removed


def remove_incident(table: EdgeTable, v_mask: torch.Tensor
                    ) -> Tuple[EdgeTable, torch.Tensor]:
    """Tombstone every LIVE edge with an endpoint in ``v_mask``."""
    live = table.state == LIVE
    if v_mask.dim() == 2:  # tenant lanes: each row's own mask
        kill = live & (v_mask.gather(1, table.src.long())
                       | v_mask.gather(1, table.dst.long()))
    else:
        kill = live & (v_mask[table.src] | v_mask[table.dst])
    state = torch.where(kill, TOMB, table.state).to(torch.int8)
    return table._replace(state=state), kill


def rehash(table: EdgeTable, new_capacity: int, max_probes: int, *,
           impl: str = "auto") -> EdgeTable:
    """Migrate every LIVE entry into a fresh table of ``new_capacity``
    (tombstones dropped; ``rehash(t, cap(t))`` is :func:`compact`).  The
    LIVE keys are unique, so the insert rounds run with no dedupe, straight
    into the fresh columns."""
    if new_capacity & (new_capacity - 1):
        raise ValueError("new_capacity must be a power of two")
    fresh = empty(new_capacity, table.src.device)
    hash_probe.insert(*fresh, table.src, table.dst, table.state == LIVE,
                      max_probes=max_probes, impl=impl)
    return fresh


def compact(table: EdgeTable, max_probes: int, *, impl: str = "auto"
            ) -> EdgeTable:
    return rehash(table, table.src.shape[0], max_probes, impl=impl)


def fill_stats(table: EdgeTable):
    """(live, tomb) slot counts as int32 scalars on the table's device
    (int32[T] for a [T, C] table)."""
    return ((table.state == LIVE).sum(-1).int(),
            (table.state == TOMB).sum(-1).int())
