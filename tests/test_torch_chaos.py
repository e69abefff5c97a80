"""The port's chaos drivers and the client's writer reroute, on the CPU.

Counterparts of the reference's tiny chaos soak (tests/test_fault.py),
the client failover cases and the tenant WAL fault (tests/test_ha.py),
plus a tiny writer-failover soak and tenant soak.  Every run's contract
is the port driver's own (zero acked-op loss against a port oracle, typed
errors only); on top of it, the writer's final state must equal the JAX
package's ``SCCService`` replaying the port's acknowledged chunks, carried
across through ``repro_torch.carry``.
"""
import dataclasses
import os
import random

import numpy as np
import pytest
import torch

from repro.core import graph_state as jgs
from repro.core.service import SCCService as JSCCService
from repro_torch import carry
from repro_torch.api import AddEdge, GraphClient
from repro_torch.api.ops import encode_updates
from repro_torch.ckpt.durable import DurableService
from repro_torch.core import graph_state as gs
from repro_torch.core.service import SCCService
from repro_torch.fault import errors as fault_errors
from repro_torch.launch import chaos
from repro_torch.launch.replica import _writer_config, states_equal

CPU = torch.device("cpu")
NV = 48


def jax_replay(cfg, ledger, *, singletons=True, **knobs):
    """The JAX package's SCCService fed exactly the acked chunks."""
    jcfg = jgs.GraphConfig(**dataclasses.asdict(cfg))
    svc = JSCCService(jcfg, state=jgs.all_singletons(jcfg) if singletons
                      else None, **knobs)
    for ops in ledger:
        svc._apply_ops(*encode_updates(ops))
    return svc


def assert_equals_jax(state, jsvc, ctx=""):
    got = carry.state_to_numpy(state)
    st = jsvc.state
    want = {"v_alive": st.v_alive, "ccid": st.ccid, "src": st.edges.src,
            "dst": st.edges.dst, "state": st.edges.state,
            "n_ccs": st.n_ccs, "gen": st.gen, "overflow": st.overflow}
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(w),
                                      err_msg=f"{ctx} {k}")


def test_chaos_soak_tiny(tmp_path):
    rep = chaos.run_chaos_soak(str(tmp_path), seed=0, profile="mixed",
                               n_chunks=12, chunk=8, nv=NV, replicas=2,
                               poll_interval=0.01, n_queries=4, device=CPU)
    assert rep["violations"] == []
    assert rep["acked"] + len(rep["failed"]) == rep["chunks"]
    assert rep["fs_triggered"] > 0 and rep["kills_fired"] > 0
    cfg = _writer_config(NV, edge_capacity=2048)
    jsvc = jax_replay(cfg, rep["ledger"], buckets=(8,),
                      proactive_grow=True)
    assert int(jsvc.gen) == rep["gen"]
    assert_equals_jax(rep["final_state"], jsvc, "chaos soak")


def test_writer_failover_tiny(tmp_path):
    rep = chaos.run_writer_failover(str(tmp_path), seed=1, n_chunks=9,
                                    chunk=8, nv=NV, device=CPU)
    assert rep["violations"] == []
    assert rep["promotions"] >= 1 and rep["post_kill_acked"] > 0
    assert rep["new_epoch"] > rep["old_epoch"]
    assert rep["client_reroutes"] >= 1
    cfg = _writer_config(NV, edge_capacity=2048)
    jsvc = jax_replay(cfg, rep["ledger"], buckets=(8,),
                      proactive_grow=True)
    assert int(jsvc.gen) == rep["gen"]
    assert_equals_jax(rep["final_state"], jsvc, "failover")


def test_tenant_soak_tiny(tmp_path):
    rep = chaos.run_tenant_soak(str(tmp_path), seed=0, tenants=2,
                                n_rounds=8, chunk=8, nv=NV, device=CPU)
    assert rep["violations"] == []
    assert rep["fs_triggered"] > 0
    cfg = _writer_config(NV, edge_capacity=512)
    for tid, ledger in rep["ledger"].items():
        jsvc = jax_replay(cfg, ledger, singletons=False, buckets=(8,),
                          scan_lengths=(1,))
        assert_equals_jax(rep["final_states"][tid], jsvc, tid)


# --------------------------------------------------- client failover ----


class _DeposedService:
    """Stub of a writer that lost leadership: every chunk bounces."""

    def __init__(self):
        self.gen = 0
        self.attempts = 0

    def _apply_ops(self, kind, u, v, *, session=None, seq=None):
        self.attempts += 1
        raise fault_errors.NotLeader("leadership moved", leader="peer",
                                     retry_after=0.001)

    def stats(self):
        return {}


class _LeaderService:
    """Stub of the current leader: applies everything."""

    def __init__(self):
        self.gen = 0
        self.applied = 0

    def _apply_ops(self, kind, u, v, *, session=None, seq=None):
        self.gen += 1
        self.applied += 1
        return np.ones(len(kind), bool), self.gen

    def stats(self):
        return {}


def test_client_reroutes_on_notleader_and_resubmits():
    old, new = _DeposedService(), _LeaderService()
    client = GraphClient(old, max_retries=4, backoff_base_s=1e-4,
                         backoff_cap_s=1e-3, rng=random.Random(0),
                         leader_resolver=lambda: new)
    res = client.submit_many([AddEdge(0, 1)])
    assert res[0].gen == 1 and new.applied == 1
    assert old.attempts == 1  # one bounce, then the session moved
    assert client.stats()["client_reroutes"] == 1
    client.submit_many([AddEdge(1, 2)])  # later ops go straight there
    assert old.attempts == 1 and new.applied == 2
    client.close()


def test_client_without_resolver_surfaces_notleader_after_retries():
    old = _DeposedService()
    client = GraphClient(old, max_retries=3, backoff_base_s=1e-4,
                         backoff_cap_s=1e-3)
    with pytest.raises(fault_errors.NotLeader):
        client.submit_many([AddEdge(0, 1)])
    assert old.attempts == 4  # initial + max_retries
    assert client.stats()["client_reroutes"] == 0
    client.close()


# ------------------------------------------------------- tenant lanes ----


def test_tenant_wal_fault_is_typed_isolated_and_counted(tmp_path):
    from repro_torch.tenancy import MultiTenantService

    cfg = gs.GraphConfig(n_vertices=8, edge_capacity=64, max_probes=16,
                         max_outer=9, max_inner=10)
    knobs = dict(buckets=(8,), scan_lengths=(1,))
    mts = MultiTenantService(cfg, directory=str(tmp_path),
                             tenant_batches=(1, 2), coalesce_ops=16,
                             flush_deadline_s=0.0, wal_sync_every=1,
                             device=CPU, **knobs)
    ta, tb = mts.create_tenant(), mts.create_tenant()
    ca = mts.client(ta, max_retries=0)
    cb = mts.client(tb, max_retries=0)
    ca.submit_many([AddEdge(0, 1)])
    cb.submit_many([AddEdge(1, 2)])
    h = mts._tenants[ta]
    real_append = h.wal.append
    state = {"failed": False}

    def sick_append(*args, **kw):
        if not state["failed"]:
            state["failed"] = True
            raise OSError(5, "injected tenant-lane disk fault")
        return real_append(*args, **kw)

    h.wal.append = sick_append
    with pytest.raises(fault_errors.Unavailable) as ei:
        ca.submit_many([AddEdge(2, 3)])
    assert ei.value.retryable and ei.value.retry_after is not None
    assert isinstance(ei.value.__cause__, OSError)
    # the fault is A's alone: B's lane flushes normally
    cb.submit_many([AddEdge(3, 4)])
    assert mts.tenant_stats(ta)["wal_faults"] == 1
    assert mts.tenant_stats(tb)["wal_faults"] == 0
    # the failed chunk was neither applied nor acked: a resubmit lands
    # exactly once and the lane stays oracle-identical, disk included
    ca.submit_many([AddEdge(2, 3)])
    ledger = ([AddEdge(0, 1)], [AddEdge(2, 3)])
    oracle = SCCService(cfg, device=CPU, **knobs)
    for ops in ledger:
        oracle._apply_ops(*encode_updates(ops))
    assert mts.tenant_gen(ta) == oracle.gen == 2
    assert states_equal(mts._tenant_state(ta), oracle.state)
    assert_equals_jax(mts._tenant_state(ta),
                      jax_replay(cfg, ledger, singletons=False, **knobs))
    for c in (ca, cb):
        c.close()
    mts.close()
    cold = DurableService.open(os.path.join(str(tmp_path), "tenants", ta),
                               snapshot_every=0, device=CPU)
    assert cold.gen == oracle.gen
    assert states_equal(cold.state, oracle.state)
    cold.close()
