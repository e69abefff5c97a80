"""Plain PyTorch versions of the edge table's hash, walk, insert rounds
and remove: ``repro.core.edge_table``'s ``_hash`` and the loops of its
``lookup``, ``insert`` (``round_body``) and ``remove``, vectorised over the
lanes.

The uint32 hash is computed in int64 masked to 32 bits; torch has no
uint32 multiply or logical shift.
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


def probe(src, dst, state, base, u, v, *, max_probes: int):
    """(found: bool[B], slot: int32[B]) -- slot is the LIVE hit slot when
    found, else the first EMPTY/TOMB slot seen (insertion point), else -1
    on probe exhaustion.  Probing stops at a hit or a truly EMPTY slot."""
    cap = src.shape[0]
    b = u.shape[0]
    dev = u.device
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    found = torch.zeros(b, dtype=torch.bool, device=dev)
    slot = torch.full((b,), -1, dtype=torch.int32, device=dev)
    free = torch.full((b,), -1, dtype=torch.int32, device=dev)
    for i in range(max_probes):
        pos = (base + i) & (cap - 1)
        pl = pos.long()
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
    nothing)."""
    cap = src.shape[0]
    b = u.shape[0]
    dev = u.device
    base = hash_slots(u, v, cap)
    found, _ = probe(src, dst, state, base, u, v, max_probes=max_probes)
    want = enable & ~found
    lane = torch.arange(b, dtype=torch.int32, device=dev)
    claims = torch.empty(cap, dtype=torch.int32, device=dev)
    placed = torch.zeros(b, dtype=torch.bool, device=dev)
    probe_at = torch.zeros(b, dtype=torch.int32, device=dev)
    rounds = 0
    for _ in range(max_probes):
        pending = want & ~placed
        if not bool(pending.any()):
            break
        rounds += 1
        pos = ((base + probe_at) & (cap - 1)).long()
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
    bool[B]``."""
    b = u.shape[0]
    dev = u.device
    found, slot = probe(src, dst, state, hash_slots(u, v, src.shape[0]), u,
                        v, max_probes=max_probes)
    hit = found & enable
    lane = torch.arange(b, dtype=torch.int32, device=dev)
    pos = torch.where(hit, slot, 0).long()
    claims = torch.empty(src.shape[0], dtype=torch.int32, device=dev)
    claims[pos] = b
    claims.scatter_reduce_(0, pos, torch.where(hit, lane, b), reduce="amin")
    owner = claims[pos]
    state[pos] = torch.where(owner < b, TOMB, state[pos]).to(torch.int8)
    return hit & (owner == lane)
