"""The typed client's run paths: ``GraphClient.submit_many`` against a
per-op reference (an ``isinstance`` split, a per-op encode and one
``Result`` built an op), ``encode_updates`` against the per-op encoding,
and which sequences take the one-run fast split."""
import dataclasses

import numpy as np
import pytest

from repro_torch import api
from repro_torch.api.client import _runs
from repro_torch.core import graph_state as gs
from repro_torch.core.broker import QueryBroker
from repro_torch.core.service import SCCService

NV = 64


class TaggedAdd(api.AddEdge):
    """A caller's own subclass of an update op: not one of the exact
    classes the fast split takes whole."""


@dataclasses.dataclass(frozen=True, slots=True)
class NamedRemove(api.RemoveEdge):
    name: str = "r"


def _service():
    cfg = gs.GraphConfig(n_vertices=NV, edge_capacity=512)
    svc = SCCService(cfg, buckets=(32,), scan_lengths=(1, 4), device="cpu")
    rng = np.random.default_rng(7)
    u, v = rng.integers(0, NV, (2, 96)).astype(np.int32)
    kind = np.full(NV, api.AddVertex.KIND, np.int32)
    svc._apply_ops(kind, np.arange(NV, dtype=np.int32), np.zeros_like(kind))
    svc._apply_ops(np.full(96, api.AddEdge.KIND, np.int32), u, v)
    return svc


def _per_op_encode(ops):
    n = len(ops)
    return (np.fromiter((op.KIND for op in ops), np.int32, n),
            np.fromiter((op.u for op in ops), np.int32, n),
            np.fromiter((op.v for op in ops), np.int32, n))


def _reference(svc, ops):
    """``submit_many`` op by op: split by ``isinstance``, encode each op,
    and build one ``Result`` an op from the service's and broker's raw
    answers."""
    broker = QueryBroker(svc)
    runs, cat = [], None
    for op in ops:
        c = "update" if isinstance(op, api.UpdateOp) else op.BROKER_KIND
        if c != cat or not runs:
            runs.append((c, []))
        cat = c
        runs[-1][1].append(op)
    out = []
    for cat, run in runs:
        if cat == "update":
            ok, gen = svc._apply_ops(*_per_op_encode(run))
            out += [api.Result(op, bool(ok[i]), gen)
                    for i, op in enumerate(run)]
            continue
        us = [op.u for op in run] if cat != "community_sizes" else None
        if cat in ("same_scc", "reachable"):
            snap = getattr(broker, cat)(us, [op.v for op in run])
        elif cat == "community_sizes":
            snap = broker.community_sizes()
        else:
            snap = getattr(broker, cat)(us)
        for i, op in enumerate(run):
            if cat == "community_sizes":
                value = np.asarray(snap.value)
            elif cat == "scc_members":
                value = np.asarray(snap.value)[i]
            elif cat == "community_of":
                value = int(snap.value[i])
            else:
                value = bool(snap.value[i])
            out.append(api.Result(op, value, int(snap.gen)))
    return out


def _updates(rng, n):
    ops = []
    for k, u, v in zip(rng.integers(0, 4, n).tolist(),
                       rng.integers(0, NV, n).tolist(),
                       rng.integers(0, NV, n).tolist()):
        ops.append([api.AddEdge(u, v), api.RemoveEdge(u, v),
                    api.AddVertex(u), api.RemoveVertex(u)][k])
    return ops


def _case(name, rng):
    pairs = rng.integers(0, NV, (2, 40)).tolist()
    if name == "updates":
        return _updates(rng, 100)
    if name == "updates_tuple":
        return tuple(_updates(rng, 70))
    if name == "query_splits":
        return _updates(rng, 50) + [api.SameSCC(1, 2)] + _updates(rng, 50)
    if name == "subclass":
        ops = _updates(rng, 60)
        ops[5:5] = [TaggedAdd(3, 4), NamedRemove(3, 4, "x")]
        return ops
    if name == "empty":
        return []
    cls = {"same_scc": api.SameSCC, "reachable": api.Reachable,
           "scc_members": api.SccMembers, "community_of": api.CommunityOf,
           "community_sizes": api.CommunitySizes}[name]
    if cls is api.CommunitySizes:
        qs = [cls() for _ in range(5)]
    elif cls in (api.SameSCC, api.Reachable):
        qs = [cls(u, v) for u, v in zip(*pairs)]
    else:
        qs = [cls(u) for u in pairs[0]]
    # a run of the kind between two update runs, as a caller mixes them
    return _updates(rng, 30) + qs + _updates(rng, 30)


CASES = ["updates", "updates_tuple", "query_splits", "subclass", "empty",
         "same_scc", "reachable", "scc_members", "community_of",
         "community_sizes"]


@pytest.mark.parametrize("name", CASES)
def test_submit_many_matches_the_per_op_reference(name):
    ops = _case(name, np.random.default_rng(CASES.index(name)))
    ref_svc, svc = _service(), _service()
    want = _reference(ref_svc, ops)
    with api.GraphClient(svc) as client:
        got = client.submit_many(ops)
    assert type(got) is list and len(got) == len(ops) == len(want)
    for op, g, w in zip(ops, got, want):
        assert type(g) is api.Result
        assert g.op is op and w.op is op
        assert g.gen == w.gen and type(g.gen) is int
        if isinstance(w.value, np.ndarray):
            assert isinstance(g.value, np.ndarray)
            assert g.value.dtype == w.value.dtype
            np.testing.assert_array_equal(g.value, w.value)
        else:
            assert type(g.value) is type(w.value) and g.value == w.value
    assert svc.gen == ref_svc.gen
    assert client.updates_submitted == sum(
        isinstance(op, api.UpdateOp) for op in ops)


def _mixed_updates():
    return [api.AddEdge(1, 2), api.RemoveEdge(2, 3), api.AddVertex(4),
            TaggedAdd(5, 6), api.RemoveVertex(7), NamedRemove(8, 9),
            api.AddEdge(10, 11)]


@pytest.mark.parametrize("ops", [
    _mixed_updates(),
    [op for op in _mixed_updates() if type(op) in api.ops.UPDATE_CLASSES],
    [TaggedAdd(1, 2)],
    [],
], ids=["with_subclasses", "exact_classes", "subclass_only", "empty"])
def test_encode_updates_matches_the_per_op_encoding(ops):
    got, want = api.encode_updates(ops), _per_op_encode(ops)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape == (len(ops),)
        np.testing.assert_array_equal(g, w)
    vertex = [isinstance(op, (api.AddVertex, api.RemoveVertex))
              for op in ops]
    assert not got[2][np.array(vertex, bool)].any()  # vertex ops: v = 0


@pytest.mark.parametrize("query", [
    api.SameSCC(0, 1), api.Reachable(0, 1), api.SccMembers(0),
    api.CommunityOf(0), api.CommunitySizes(), "add_edge"],
    ids=["same_scc", "reachable", "scc_members", "community_of",
         "community_sizes", "not_an_op"])
@pytest.mark.parametrize("where", [0, 3])
def test_encode_updates_refuses_what_is_not_an_update(query, where):
    ops = _mixed_updates()[:3]
    ops.insert(where, query)
    with pytest.raises(TypeError):
        api.encode_updates(ops)


@pytest.mark.parametrize("ops, fast", [
    ([api.AddEdge(0, 1), api.AddVertex(2), api.RemoveVertex(2),
      api.RemoveEdge(0, 1)], True),
    ((api.AddEdge(0, 1), api.RemoveEdge(0, 1)), True),
    ([api.AddEdge(0, 1), TaggedAdd(1, 2)], False),
    ([api.AddEdge(0, 1), api.SameSCC(0, 1)], False),
    ([], False),
], ids=["list", "tuple", "subclass", "query", "empty"])
def test_the_fast_split_takes_only_known_update_classes(ops, fast):
    runs = list(_runs(ops))
    assert (len(runs) == 1 and runs[0][1] is ops) == fast
    assert [op for _, run in runs for op in run] == list(ops)
    # an iterator is split op by op, as before
    assert [(c, list(r)) for c, r in _runs(iter(ops))] == \
        [(c, list(r)) for c, r in runs]
