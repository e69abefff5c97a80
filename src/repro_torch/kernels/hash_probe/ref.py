"""Plain PyTorch version of the bounded open-addressing probe walk: the
sequential loop of ``repro.core.edge_table.lookup``, vectorised over the
query lanes."""
from __future__ import annotations

import torch

EMPTY, LIVE, TOMB = 0, 1, 2


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
