"""The plain reference against hand-built graphs, an independent oracle
and the port's own step at a smoke size."""
import random

import numpy as np
import pytest
import torch

from bench.reference import smscc as ref

A, R = ref.ADD_EDGE, ref.REM_EDGE


def _reach(nv, edges, u, v):
    adj = [[] for _ in range(nv)]
    for a, b in edges:
        adj[a].append(b)
    seen, todo = {u}, [u]
    while todo:
        for y in adj[todo.pop()]:
            if y not in seen:
                seen.add(y)
                todo.append(y)
    return v in seen


def _oracle_labels(nv, edges):
    """Each vertex's least mutually reachable vertex, by a search from
    every vertex."""
    return [min(w for w in range(nv)
                if _reach(nv, edges, v, w) and _reach(nv, edges, w, v))
            for v in range(nv)]


def _t(edges):
    return (torch.tensor([e[0] for e in edges], dtype=torch.long),
            torch.tensor([e[1] for e in edges], dtype=torch.long))


@pytest.mark.parametrize("edges,nv,want", [
    ([], 3, [0, 1, 2]),
    ([(0, 1), (1, 2), (2, 0)], 4, [0, 0, 0, 3]),
    ([(2, 1), (1, 2), (1, 1), (3, 0)], 4, [0, 1, 1, 3]),
    ([(0, 1), (1, 0), (1, 2), (2, 3), (3, 2), (3, 4)], 5, [0, 0, 2, 2, 4]),
    ([(4, 3), (3, 2), (2, 4), (0, 4), (1, 0), (0, 1)], 5, [0, 0, 2, 2, 2]),
])
def test_scc_labels_hand_built(edges, nv, want):
    assert ref.scc_labels(nv, *_t(edges)).tolist() == want


def test_scc_labels_dead_vertices_get_the_sentinel():
    alive = torch.tensor([True, False, True])
    got = ref.scc_labels(3, *_t([(0, 2), (2, 0), (0, 1), (1, 0)]), alive)
    assert got.tolist() == [0, 3, 0]


@pytest.mark.parametrize("seed", range(4))
def test_scc_and_reach_match_an_independent_oracle(seed):
    rng = random.Random(seed)
    for _ in range(40):
        nv = rng.randint(1, 30)
        edges = [(rng.randrange(nv), rng.randrange(nv))
                 for _ in range(rng.randint(0, 3 * nv))]
        s, d = _t(edges)
        assert ref.scc_labels(nv, s, d).tolist() == _oracle_labels(nv, edges)
        qu = [rng.randrange(nv) for _ in range(16)]
        qv = [rng.randrange(nv) for _ in range(16)]
        got = ref.reachable(nv, s, d, torch.tensor(qu), torch.tensor(qv),
                            block=5).tolist()
        assert got == [_reach(nv, edges, a, b) for a, b in zip(qu, qv)]


def test_replay_step_linearizes_removes_before_adds():
    rp = ref.EdgeSetReplay(4, *_t([(0, 1), (1, 2)]))
    # lane order: add (0,1) [present before, removed later in the step:
    # the add still succeeds], remove (0,1), remove (0,1) again, add
    # (2,3) twice, remove a missing edge, an out-of-range add
    kind = torch.tensor([A, R, R, A, A, R, A])
    u = torch.tensor([0, 0, 0, 2, 2, 3, 4])
    v = torch.tensor([1, 1, 1, 3, 3, 3, 0])
    ok = rp.step(kind, u, v)
    assert ok.tolist() == [True, True, False, True, False, False, False]
    assert sorted(zip(*(x.tolist() for x in rp.edges()))) == \
        [(0, 1), (1, 2), (2, 3)]


def test_replay_refuses_vertex_ops():
    rp = ref.EdgeSetReplay(4, *_t([]))
    with pytest.raises(ValueError):
        rp.step(torch.tensor([2]), torch.tensor([0]), torch.tensor([0]))


@pytest.mark.parametrize("seed", range(3))
def test_reference_agrees_with_the_port_at_smoke_size(seed):
    """The port's CPU step and the reference on the same random batches:
    every ack, then the SCC labels of the last state."""
    from repro_torch.configs import smscc
    from repro_torch.core import dynamic
    from repro_torch.core import graph_state as gs

    nv = 48
    cfg = smscc.smoke_config(n_vertices=nv, edge_capacity=512)
    rng = np.random.default_rng(seed)
    src = rng.integers(0, nv, 60).astype(np.int32)
    dst = rng.integers(0, nv, 60).astype(np.int32)
    state = dynamic.recompute(gs.from_arrays(cfg, src, dst, device="cpu"),
                              cfg)
    rp = ref.EdgeSetReplay(nv, torch.from_numpy(src), torch.from_numpy(dst))
    for _ in range(6):
        kind = rng.choice([A, R], 32).astype(np.int32)
        u = rng.integers(0, nv, 32).astype(np.int32)
        v = rng.integers(0, nv, 32).astype(np.int32)
        rem = np.nonzero(kind == R)[0]  # half the removes name live edges
        live = rp.live.numpy()
        pick = live[rng.integers(0, live.size, rem.size)]
        u[rem[::2]], v[rem[::2]] = pick[::2] // nv, pick[::2] % nv
        state, ok = dynamic.apply_batch(state, dynamic.make_ops(kind, u, v),
                                        cfg)
        want = rp.step(*(torch.from_numpy(x) for x in (kind, u, v)))
        assert ok.tolist() == want.tolist()
    assert state.ccid.long().tolist() == \
        ref.scc_labels(nv, *rp.edges()).tolist()
