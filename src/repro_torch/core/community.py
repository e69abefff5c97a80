"""Wait-free queries and the paper's community application (§5.3):
batched gathers over the label array of one committed snapshot.

Mirrors ``repro.core.community``.
"""
from __future__ import annotations

import torch

from repro_torch.core import graph_state as gs


def check_scc(state: gs.GraphState, u, v):
    """bool[Q]: u and v alive and in the same SCC."""
    nv = state.ccid.shape[0]
    u = u.clamp(0, nv - 1)
    v = v.clamp(0, nv - 1)
    alive = state.v_alive[u] & state.v_alive[v]
    return alive & (state.ccid[u] == state.ccid[v])


def belongs_to_community(state: gs.GraphState, u):
    """int32[Q]: the community (SCC) id of u; ``n_vertices`` if absent."""
    nv = state.ccid.shape[0]
    uu = u.clamp(0, nv - 1)
    return torch.where(state.v_alive[uu], state.ccid[uu], nv)


def community_sizes(state: gs.GraphState):
    """int32[NV]: histogram of community sizes by representative id."""
    nv = state.ccid.shape[0]
    idx = torch.where(state.v_alive, state.ccid, nv).clamp(max=nv)
    hist = torch.zeros(nv + 1, dtype=torch.int32, device=idx.device)
    return hist.index_add_(0, idx, state.v_alive.int())[:nv]


def largest_community(state: gs.GraphState):
    """(representative id, size) of the largest SCC."""
    sizes = community_sizes(state)
    rep = sizes.argmax()
    return rep.int(), sizes[rep]


def same_community_pairs(state: gs.GraphState, users):
    """All-pairs community matrix for a user cohort (friend-suggestion app).

    users: int32[K] -> bool[K, K]; entry (i, j) = suggest i<->j candidate.
    """
    lab = belongs_to_community(state, users)
    ok = lab < state.ccid.shape[0]
    return (lab[:, None] == lab[None, :]) & ok[:, None] & ok[None, :]
