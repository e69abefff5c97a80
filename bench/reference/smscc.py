"""The plain reference the benchmark holds the SMSCC service to.

Written from the configuration's stated semantics, in plain PyTorch, with
nothing taken from the program under test:

- an update step is batch-atomic and linearized RemoveEdge before AddEdge,
  ties by lane index: a RemoveEdge succeeds when its edge is live before
  the step and no earlier lane of the step removed it; an AddEdge succeeds
  when its edge is absent once the step's removes are applied and no
  earlier lane of the step added it; out-of-range endpoints fail
  (:class:`EdgeSetReplay`);
- ``Reachable(u, v)``: a path of live edges leads from u to v (u reaches
  itself) (:func:`reachable`);
- the SCC partition, each vertex labelled with the least vertex id of its
  strongly connected component (:func:`scc_labels`).

The live edge set is a sorted tensor of keys ``u * nv + v``.  Every
function runs on whatever device its tensors are on; the benchmark runs
it on the card once the program's state is freed.
"""
from __future__ import annotations

import torch

ADD_EDGE = 0
REM_EDGE = 1
NOP = 4


def edge_keys(u: torch.Tensor, v: torch.Tensor, nv: int) -> torch.Tensor:
    return u.long() * nv + v.long()


def first_of_key(keys: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """True at each masked lane whose key no earlier masked lane holds."""
    idx = torch.nonzero(mask).flatten()
    out = torch.zeros_like(mask)
    if idx.numel() == 0:
        return out
    k = keys[idx]
    order = torch.argsort(k, stable=True)
    ks = k[order]
    start = torch.ones_like(ks, dtype=torch.bool)
    start[1:] = ks[1:] != ks[:-1]
    out[idx[order[start]]] = True
    return out


class EdgeSetReplay:
    """The live edge set of a graph whose vertices are all alive, stepped
    through update batches as the configuration states them."""

    def __init__(self, nv: int, src: torch.Tensor, dst: torch.Tensor):
        self.nv = nv
        self.live = torch.unique(edge_keys(src, dst, nv))

    def contains(self, keys: torch.Tensor) -> torch.Tensor:
        if self.live.numel() == 0:
            return torch.zeros_like(keys, dtype=torch.bool)
        pos = torch.searchsorted(self.live, keys)
        return self.live[pos.clamp(max=self.live.numel() - 1)] == keys

    def step(self, kind, u, v) -> torch.Tensor:
        """Apply one batch-atomic step; returns each lane's ack."""
        kind, u, v = (torch.as_tensor(x).to(self.live.device)
                      for x in (kind, u, v))
        other = (kind != ADD_EDGE) & (kind != REM_EDGE) & (kind != NOP)
        if bool(other.any()):
            raise ValueError("the reference replays edge ops only")
        nv = self.nv
        in_range = (u >= 0) & (u < nv) & (v >= 0) & (v < nv)
        keys = edge_keys(u, v, nv)
        rem = (kind == REM_EDGE) & in_range
        ok_rem = rem & self.contains(keys) & first_of_key(keys, rem)
        if bool(ok_rem.any()):
            gone = torch.zeros_like(self.live, dtype=torch.bool)
            gone[torch.searchsorted(self.live, keys[ok_rem])] = True
            self.live = self.live[~gone]
        add = (kind == ADD_EDGE) & in_range
        ok_add = add & ~self.contains(keys) & first_of_key(keys, add)
        if bool(ok_add.any()):
            self.live = torch.sort(torch.cat([self.live, keys[ok_add]]))[0]
        return ok_rem | ok_add

    def edges(self):
        """(src, dst) int64 tensors of the live edges."""
        return self.live // self.nv, self.live % self.nv


def reachable(nv: int, src: torch.Tensor, dst: torch.Tensor,
              u: torch.Tensor, v: torch.Tensor,
              block: int | None = None) -> torch.Tensor:
    """bool[Q]: a path of the given edges leads from u[i] to v[i].  A
    breadth-first sweep from ``block`` sources at a time (by default as
    many as keep each round's edge-by-source counts to 2^28): each round
    every edge carries its source's reached marks to its destination,
    until a round adds nothing."""
    dev = src.device
    if block is None:
        block = max(1, min(256, 2 ** 28 // max(1, src.numel())))
    src, dst = src.long(), dst.long()
    u = torch.as_tensor(u, device=dev).long()
    v = torch.as_tensor(v, device=dev).long()
    out = torch.zeros(u.numel(), dtype=torch.bool, device=dev)
    for lo in range(0, u.numel(), block):
        us = u[lo:lo + block]
        q = us.numel()
        cols = torch.arange(q, device=dev)
        reached = torch.zeros((nv, q), dtype=torch.int32, device=dev)
        reached[us, cols] = 1
        while True:
            got = torch.zeros_like(reached).index_add_(0, dst, reached[src])
            nxt = torch.maximum(reached, got.clamp(max=1))
            if torch.equal(nxt, reached):
                break
            reached = nxt
        out[lo:lo + q] = reached[v[lo:lo + block], cols] > 0
    return out


def _sweep(src, dst, val, active_v):
    """Least value reaching each active vertex along the edges, to a
    fixpoint (edges and values already restricted to the active part)."""
    while True:
        nxt = val.scatter_reduce(0, dst, val[src], reduce="amin")
        nxt = torch.where(active_v, nxt, val)
        if bool((nxt == val).all()):
            return val
        val = nxt


def scc_labels(nv: int, src: torch.Tensor, dst: torch.Tensor,
               alive: torch.Tensor | None = None) -> torch.Tensor:
    """int64[NV]: the least vertex id of each vertex's strongly connected
    component, ``nv`` for a dead vertex.

    Each outer round trims the vertices that no other active vertex
    enters or leaves (each its own component), gives every active vertex
    the least id that reaches it, and settles the vertices that reach the
    vertex whose id they hold: that vertex's component."""
    dev = src.device
    src, dst = src.long(), dst.long()
    vid = torch.arange(nv, device=dev)
    if alive is None:
        alive = torch.ones(nv, dtype=torch.bool, device=dev)
    label = torch.full((nv,), nv, dtype=torch.long, device=dev)
    active = alive.clone()
    loop = src == dst
    src, dst = src[~loop], dst[~loop]
    while bool(active.any()):
        e = active[src] & active[dst]
        s, d = src[e], dst[e]
        while True:  # trim
            ein = torch.bincount(d, minlength=nv)
            eout = torch.bincount(s, minlength=nv)
            t = active & ((ein == 0) | (eout == 0))
            if not bool(t.any()):
                break
            label[t] = vid[t]
            active &= ~t
            e = active[s] & active[d]
            s, d = s[e], d[e]
        if not bool(active.any()):
            break
        big = torch.full((nv,), nv, dtype=torch.long, device=dev)
        color = _sweep(s, d, torch.where(active, vid, big), active)
        same = color[s] == color[d]
        cs, cd = s[same], d[same]
        member = active & (color == vid)
        while True:  # back from each root inside its colour
            nxt = member.clone()
            nxt[cs[member[cd]]] = True
            if bool((nxt == member).all()):
                break
            member = nxt
        label[member] = color[member]
        active &= ~member
    return label
