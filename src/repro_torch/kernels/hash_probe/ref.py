"""Plain PyTorch versions of the edge table's hash, walk, insert rounds
and remove: ``repro.core.edge_table``'s ``_hash`` and the loops of its
``lookup``, ``insert`` (``round_body``) and ``remove``, vectorised over the
lanes.

The uint32 hash is computed in int64 masked to 32 bits; torch has no
uint32 multiply or logical shift.

Tenant rows: given [T, C] columns and [T, B] lanes, lane (t, j) walks row
t only (slot ``t * C + ((base + p) & (C - 1))`` of the flattened table)
and slots come back row-local; ties between lanes of one row go to the
lower lane index, as in the single table.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.u32 import M32 as _M32, mul32

EMPTY, LIVE, TOMB = 0, 1, 2


def hash_slots(u: torch.Tensor, v: torch.Tensor, capacity: int
               ) -> torch.Tensor:
    """The JAX package's uint32 mixing of (u, v) into [0, capacity)."""
    u = u.long() & _M32
    v = v.long() & _M32
    h = mul32(u, 0x9E3779B1) ^ ((v + 0x85EBCA77 + ((u << 6) & _M32)
                                 + (u >> 2)) & _M32)
    h = h ^ (h >> 15)
    h = mul32(h, 0x2C1B3C6D)
    h = h ^ (h >> 12)
    return (h & (capacity - 1)).int()


def _flat(cols, lanes):
    """Flatten [T, C] columns and [T, B] lanes: (cols, lanes, row capacity
    C, per-lane row offset int32[T B], T, B) -- offset 0 for one table."""
    cap = cols[0].shape[-1]
    if cols[0].dim() == 1:
        return cols, lanes, cap, 0, None, None
    t, b = lanes[0].shape
    off = (torch.arange(t, dtype=torch.int32, device=lanes[0].device)
           * cap)[:, None].expand(t, b).reshape(-1)
    return ([c.reshape(-1) for c in cols],
            [x.reshape(-1) for x in lanes], cap, off, t, b)


def probe(src, dst, state, base, u, v, *, max_probes: int):
    """(found: bool[B], slot: int32[B]) -- slot is the LIVE hit slot when
    found, else the first EMPTY/TOMB slot seen (insertion point), else -1
    on probe exhaustion.  Probing stops at a hit or a truly EMPTY slot.
    [T, C] columns with [T, B] lanes: per row, slots row-local."""
    (src, dst, state), (base, u, v), cap, off, t, b = _flat(
        (src, dst, state), (base, u, v))
    found, slot = _probe(src, dst, state, base, u, v, max_probes, cap, off)
    if t is None:
        return found, slot
    return found.reshape(t, b), slot.reshape(t, b)


def _probe(src, dst, state, base, u, v, max_probes, cap, off):
    """probe over flat columns; slots row-local (``off`` added to index)."""
    b = u.shape[0]
    dev = u.device
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    found = torch.zeros(b, dtype=torch.bool, device=dev)
    slot = torch.full((b,), -1, dtype=torch.int32, device=dev)
    free = torch.full((b,), -1, dtype=torch.int32, device=dev)
    for i in range(max_probes):
        pos = (base + i) & (cap - 1)
        pl = (pos + off).long()
        st = state[pl]
        hit = (st == LIVE) & (src[pl] == u) & (dst[pl] == v)
        free = torch.where(~done & (st != LIVE) & (free < 0), pos, free)
        slot = torch.where(~done & hit, pos, slot)
        found = found | (~done & hit)
        done = done | hit | (st == EMPTY)
        if bool(done.all()):  # later rounds change nothing
            break
    return found, torch.where(found, slot, free)


def insert(src, dst, state, u, v, enable, *, max_probes: int):
    """The insert's hash, lookup and claim rounds, writing into ``src``,
    ``dst`` and ``state`` in place.  ``enable`` is already free of
    intra-batch duplicates.  Returns ``(placed: bool[B], failed: bool[B],
    rounds)``, ``rounds`` a 0-d int32 tensor: the rounds run before no lane
    was pending (JAX runs all ``max_probes``; the rounds after change
    nothing).  [T, C] columns with [T, B] lanes: each row's lanes insert
    into that row (rounds shared)."""
    cols = (src, dst, state)
    (fsrc, fdst, fstate), (u, v, enable), cap, off, t, b = _flat(
        cols, (u, v, enable))
    placed, failed, rounds = _insert(fsrc, fdst, fstate, u, v, enable,
                                     max_probes, cap, off)
    if t is None:
        return placed, failed, rounds
    for col, flat in zip(cols, (fsrc, fdst, fstate)):
        col.copy_(flat.view_as(col))
    return placed.reshape(t, b), failed.reshape(t, b), rounds


def _insert(src, dst, state, u, v, enable, max_probes, cap, off):
    b = u.shape[0]
    dev = u.device
    base = hash_slots(u, v, cap)
    found, _ = _probe(src, dst, state, base, u, v, max_probes, cap, off)
    want = enable & ~found
    lane = torch.arange(b, dtype=torch.int32, device=dev)
    claims = torch.empty(src.shape[0], dtype=torch.int32, device=dev)
    placed = torch.zeros(b, dtype=torch.bool, device=dev)
    probe_at = torch.zeros(b, dtype=torch.int32, device=dev)
    rounds = 0
    for _ in range(max_probes):
        pending = want & ~placed
        if not bool(pending.any()):
            break
        rounds += 1
        pos = (((base + probe_at) & (cap - 1)) + off).long()
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
        probe_at = torch.where(pending & ~win, probe_at + 1, probe_at)
    return (placed, want & ~placed,
            torch.tensor(rounds, dtype=torch.int32, device=dev))


def remove(src, dst, state, u, v, enable, *, max_probes: int):
    """Remove's hash, lookup, lowest-lane claim of each hit slot and TOMB
    write, writing into ``state`` in place.  Returns ``removed:
    bool[B]`` ([T, B] over [T, C] columns)."""
    (fsrc, fdst, fstate), (u, v, enable), cap, off, t, b = _flat(
        (src, dst, state), (u, v, enable))
    removed = _remove(fsrc, fdst, fstate, u, v, enable, max_probes, cap,
                      off)
    if t is None:
        return removed
    state.copy_(fstate.view_as(state))
    return removed.reshape(t, b)


def _remove(src, dst, state, u, v, enable, max_probes, cap, off):
    b = u.shape[0]
    dev = u.device
    found, slot = _probe(src, dst, state, hash_slots(u, v, cap), u, v,
                         max_probes, cap, off)
    hit = found & enable
    lane = torch.arange(b, dtype=torch.int32, device=dev)
    pos = (torch.where(hit, slot, 0) + off).long()
    claims = torch.empty(src.shape[0], dtype=torch.int32, device=dev)
    claims[pos] = b
    claims.scatter_reduce_(0, pos, torch.where(hit, lane, b), reduce="amin")
    owner = claims[pos]
    state[pos] = torch.where(owner < b, TOMB, state[pos]).to(torch.int8)
    return hit & (owner == lane)
