"""The port's replicated serving held to the reference: WAL-tailing read
replicas, the replica set's routing, concurrent readers, fault injection,
the write lease and the serving entry points, all on the CPU.

A replica of the port tails a store the JAX package writes and must equal
the JAX writer, leaf for leaf, at every generation it passes through; a
port writer, its replica and the sequential oracle (``tests/oracle.py``)
must agree op for op; concurrent readers must see monotone generations
and, at each stamped generation, the oracle's answers.  Replicas are
driven by hand (``auto_tail=False``) except where the threaded path is
the point.  Seeds are fixed; every value is an integer or a boolean, so
equality is exact.
"""
import collections
import dataclasses
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from oracle import SeqSCC
from repro.ckpt.durable import DurableService as JDurable
from repro.core import graph_state as jgs
from repro_torch import carry
from repro_torch.api import (AddEdge, Consistency, GraphClient, RemoveEdge,
                             SameSCC, encode_updates)
from repro_torch.ckpt.durable import FENCED, DurableService
from repro_torch.core import dynamic
from repro_torch.core import graph_state as gs
from repro_torch.core import service as svc_mod
from repro_torch.core.broker import QueryBroker
from repro_torch.core.replicas import Replica, ReplicaSet
from repro_torch.core.service import SCCService
from repro_torch.fault import errors as fault_errors
from repro_torch.fault.inject import (FaultPlan, FsFault, ReplicaKill, Stall,
                                      fire_kills, injected)
from repro_torch.ha.lease import FileLease
from repro_torch.launch import replica as replica_launch
from repro_torch.launch import stream

NV = 24
KNOBS = dict(buckets=(8,), proactive_grow=True)
PHASE = {dynamic.REM_VERTEX: 0, dynamic.REM_EDGE: 1,
         dynamic.ADD_VERTEX: 2, dynamic.ADD_EDGE: 3}
QU = np.arange(8, dtype=np.int32) % NV
QV = (QU * 5 + 3) % NV
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_cfg():
    return jgs.GraphConfig(n_vertices=NV, edge_capacity=64, max_probes=16,
                           max_outer=NV + 1, max_inner=NV + 2)


def tiny_cfg():
    return carry.config_from_dict(dataclasses.asdict(jax_cfg()))


def make_writer(directory, **durable_kw):
    cfg = tiny_cfg()
    durable_kw.setdefault("snapshot_every", 0)  # boot snapshot only
    durable_kw.setdefault("recover_probe_s", 0.0)
    return DurableService(cfg, str(directory),
                          state=gs.all_singletons(cfg, "cpu"), sync_every=1,
                          **durable_kw, **KNOBS)


def replica(directory, i=0, **kw):
    return Replica(str(directory), i, auto_tail=False, query_buckets=(8,),
                   device="cpu", **kw)


def random_chunk(rng, n=8):
    return (rng.integers(0, 4, n).astype(np.int32),
            rng.integers(0, NV, n).astype(np.int32),
            rng.integers(0, NV, n).astype(np.int32))


def drain(rep):
    while True:  # a resync applies nothing itself but re-seats the cursor
        before = rep.resyncs
        if rep.tail_once() == 0 and rep.resyncs == before:
            return


def jax_arrays(st) -> dict:
    return {"v_alive": np.asarray(st.v_alive), "ccid": np.asarray(st.ccid),
            "src": np.asarray(st.edges.src), "dst": np.asarray(st.edges.dst),
            "state": np.asarray(st.edges.state),
            "n_ccs": np.asarray(st.n_ccs), "gen": np.asarray(st.gen),
            "overflow": np.asarray(st.overflow)}


def assert_same(a, b, ctx=""):
    """Two port services hold the same state and answer alike."""
    assert replica_launch.states_equal(a.state, b.state), ctx
    np.testing.assert_array_equal(
        svc_mod.same_scc_on(a.state, a.cfg, QU, QV),
        svc_mod.same_scc_on(b.state, b.cfg, QU, QV), err_msg=ctx)


def oracle_chunk(oracle, kind, u, v):
    """Per-op oracle acks for one bucket (ops phase-sorted, as the
    engine's removal/insert phases run)."""
    want = np.zeros(len(kind), bool)
    for i in sorted(range(len(kind)), key=lambda i: (PHASE[int(kind[i])], i)):
        k, uu, vv = int(kind[i]), int(u[i]), int(v[i])
        if k == dynamic.ADD_EDGE:
            want[i] = oracle.add_edge(uu, vv)
        elif k == dynamic.REM_EDGE:
            want[i] = oracle.remove_edge(uu, vv)
        elif k == dynamic.ADD_VERTEX:
            want[i] = oracle.add_vertex(uu)
        else:
            want[i] = oracle.remove_vertex(uu)
    return want


# ------------------------------------------------------------ tailing ----


def test_replica_tails_a_jax_store_bit_identically_at_every_gen(tmp_path):
    """The port's replica boots from the JAX writer's generation-0 boot
    snapshot and, one record at a time, equals the JAX writer's state at
    every committed generation."""
    jcfg = jax_cfg()
    writer = JDurable(jcfg, str(tmp_path), state=jgs.all_singletons(jcfg),
                      sync_every=1, snapshot_every=0, **KNOBS)
    rng = np.random.default_rng(7)
    hist = {0: jax_arrays(writer.state)}
    for _ in range(6):
        _, gen = writer._apply_ops(*random_chunk(rng))
        hist[gen] = jax_arrays(writer.state)
    writer.close()
    rep = replica(tmp_path)
    assert rep.gen == 0
    seen = [0]
    while rep.tail_once(max_records=1):
        seen.append(rep.gen)
        got = carry.state_to_numpy(rep.service.state)
        for k, want in hist[rep.gen].items():
            np.testing.assert_array_equal(got[k], want, err_msg=k)
    assert seen == sorted(hist) and rep.applied_records == 6
    snap = rep.broker.same_scc(QU, QV)  # inline flush, no dispatcher
    assert snap.gen == rep.gen == max(hist)


def test_replica_bootstraps_and_tails_the_port_writer(tmp_path):
    writer = make_writer(tmp_path)
    rng = np.random.default_rng(7)
    for _ in range(6):
        writer._apply_ops(*random_chunk(rng))
    rep = replica(tmp_path)
    assert rep.gen == 0, "bootstraps from the generation-0 boot snapshot"
    drain(rep)
    assert rep.gen == writer.gen and rep.applied_records == 6
    assert_same(rep.service, writer, "after full tail")
    assert rep.service.edge_set() == writer.edge_set()
    snap = rep.broker.same_scc(QU, QV)
    assert snap.gen == rep.gen
    np.testing.assert_array_equal(
        snap.value, svc_mod.same_scc_on(writer.state, writer.cfg, QU, QV))
    writer.close()


def test_at_least_defers_on_stale_replica_until_tailed(tmp_path):
    writer = make_writer(tmp_path)
    rng = np.random.default_rng(8)
    for _ in range(4):
        writer._apply_ops(*random_chunk(rng))
    goal = writer.gen
    rep = replica(tmp_path)
    assert rep.tail_once(max_records=2) == 2
    stale_gen = rep.gen
    assert 0 < stale_gen < goal
    fut = rep.broker.submit("same_scc", QU, QV, min_gen=goal)
    assert rep.broker.flush() == 0, "stale replica must not answer"
    assert not fut.done() and rep.broker.gen_waits == 1
    free = rep.broker.submit("same_scc", QU, QV)  # not delayed behind it
    assert rep.broker.flush() == len(QU)
    assert free.result().gen == stale_gen and not fut.done()
    drain(rep)
    assert rep.broker.flush() == len(QU)
    snap = fut.result()
    assert snap.gen >= goal
    np.testing.assert_array_equal(
        snap.value, svc_mod.same_scc_on(writer.state, writer.cfg, QU, QV))
    writer.close()


def test_replicaset_routes_fresh_and_parks_stale(tmp_path):
    writer = make_writer(tmp_path)
    rng = np.random.default_rng(9)
    for _ in range(4):
        writer._apply_ops(*random_chunk(rng))
    g4 = writer.gen
    rs = ReplicaSet(str(tmp_path), 2, auto_tail=False, query_buckets=(8,),
                    device="cpu")
    r0, r1 = rs.replicas
    drain(r0)
    assert rs.min_gen == 0
    snap = rs.resolve(rs.submit("same_scc", QU, QV, min_gen=g4), min_gen=g4)
    assert rs.routed_fresh == 1 and rs.routed_stale == 0
    assert snap.gen >= g4 and r1.broker.served == 0
    writer._apply_ops(*random_chunk(rng))
    g5 = writer.gen
    fut = rs.submit("same_scc", QU, QV, min_gen=g5)
    assert rs.routed_stale == 1
    assert r0.tail_once() > 0 and r0.gen == g5  # parked on the freshest
    assert rs.resolve(fut, min_gen=g5).gen >= g5
    drain(r1)
    assert rs.wait_all_for_gen(g5, timeout=1.0) == g5
    s = rs.stats()
    assert s["replica0_gen"] == s["replica1_gen"] == g5
    rs.stop()
    writer.close()


def test_writer_replica_oracle_differential(tmp_path):
    writer = make_writer(tmp_path)
    oracle = SeqSCC(NV)
    for i in range(NV):
        assert oracle.add_vertex(i)  # all_singletons boots everything live
    rep = replica(tmp_path)
    rng = np.random.default_rng(17)
    last = -1
    for round_no in range(8):
        kind, u, v = random_chunk(rng)
        ok, gen = writer._apply_ops(kind, u, v)
        assert ok.tolist() == oracle_chunk(oracle, kind, u, v).tolist(), \
            f"round {round_no}: writer acks diverge from the oracle"
        drain(rep)
        assert rep.gen == writer.gen == gen
        assert rep.service.state.ccid.tolist() == \
            writer.state.ccid.tolist() == oracle.ccid()
        assert rep.service.edge_set() == writer.edge_set() == oracle.edges
        snap = rep.broker.same_scc(QU, QV)
        assert snap.gen >= last
        last = snap.gen
        lab = oracle.ccid()
        assert snap.value.tolist() == [lab[a] == lab[b] and lab[a] < NV
                                       for a, b in zip(QU, QV)]
    writer.close()


def test_replica_resyncs_after_wal_trim(tmp_path):
    writer = make_writer(tmp_path, segment_bytes=128,
                         trim_on_snapshot=True)
    rng = np.random.default_rng(23)
    writer._apply_ops(*random_chunk(rng))
    rep = replica(tmp_path)
    assert rep.tail_once(max_records=1) == 1  # cursor parked early
    for _ in range(8):
        writer._apply_ops(*random_chunk(rng))
    writer.snapshot_now()  # trims the WAL below the snapshot gen
    writer._apply_ops(*random_chunk(rng))
    drain(rep)
    assert rep.resyncs >= 1, "a trimmed cursor must trigger a resync"
    assert rep.gen == writer.gen == int(rep.service.state.gen)
    assert_same(rep.service, writer, "post-resync")
    writer.close()


def test_graph_client_over_replicaset_read_your_writes(tmp_path):
    writer = make_writer(tmp_path)
    rs = ReplicaSet(str(tmp_path), 2, auto_tail=False, query_buckets=(8,),
                    device="cpu")
    client = GraphClient(writer, broker=rs,
                         consistency=Consistency.READ_YOUR_WRITES)
    assert client.submit(AddEdge(1, 2)).result().value
    ack = client.submit(AddEdge(2, 1)).result()
    assert client.token == ack.gen == writer.gen
    for r in rs.replicas:
        drain(r)
    got = client.submit(SameSCC(1, 2)).result()
    assert got.value is True and got.gen >= ack.gen
    client.submit(RemoveEdge(2, 1)).result()
    for r in rs.replicas:
        drain(r)
    got = client.submit(SameSCC(1, 2)).result()
    assert got.value is False and got.gen >= client.token
    rs.stop()
    writer.close()


def test_threaded_replicaset_serves_ryw_and_converges(tmp_path):
    """Tail threads and broker dispatchers running: read-your-writes
    rounds never see a stamp below the session floor, and every replica
    ends equal to the writer."""
    writer = make_writer(tmp_path)
    rs = ReplicaSet(str(tmp_path), 2, query_buckets=(8,),
                    poll_interval=0.005, device="cpu")
    rng = np.random.default_rng(31)
    client = GraphClient(writer, broker=rs,
                         consistency=Consistency.READ_YOUR_WRITES)
    try:
        for _ in range(6):
            writer._apply_ops(*random_chunk(rng))
            token = client.submit(AddEdge(0, 1)).result().gen
            res = client.submit_many([SameSCC(int(a), int(b))
                                      for a, b in zip(QU, QV)])
            assert res[0].gen >= token
        rs.wait_all_for_gen(writer.gen, timeout=30)
        for r in rs.replicas:
            assert r.gen == writer.gen
            assert_same(r.service, writer, f"replica {r.replica_id}")
        assert rs.routed_fresh + rs.routed_stale >= 6
    finally:
        rs.stop()
        writer.close()


# ------------------------------------------------- concurrent readers ----


def _reach(edges, u, v):
    adj = collections.defaultdict(list)
    for a, b in edges:
        adj[a].append(b)
    seen, frontier = {u}, [u]
    while frontier:
        frontier = [y for x in frontier for y in adj[x] if y not in seen]
        seen.update(frontier)
    return v in seen


@pytest.mark.parametrize("seed", [0, 1])
def test_concurrent_readers_monotone_and_match_oracle(seed):
    """run_concurrent_stream: every reader's generations only rise, and
    every answered batch equals the sequential oracle at the generation
    stamped on it (a committed generation of the update stream)."""
    cfg = tiny_cfg()
    svc = SCCService(cfg, state=gs.all_singletons(cfg, "cpu"),
                     buckets=(8, 16))
    record = []
    rep = stream.run_concurrent_stream(
        svc, 12 * 20, readers=3, chunk=20, n_queries=8, reach_queries=4,
        add_frac=0.7, seed=seed, record=record)
    assert rep["ops"] == 240 and rep["queries"] > 0
    assert rep["gen"] == svc.gen and rep["readers"] == 3
    # the same stream replayed serially: the generation after each chunk
    # (the only ones readers can see) and the oracle's state there
    plain = SCCService(cfg, state=gs.all_singletons(cfg, "cpu"),
                       buckets=(8, 16))
    oracle = SeqSCC(NV)
    for i in range(NV):
        oracle.add_vertex(i)
    hist = {0: (oracle.ccid(), set(oracle.edges))}
    for step in range(12):
        ops = stream.typed_op_stream(NV, 20, step=step, add_frac=0.7,
                                     seed=seed)
        kind, u, v = encode_updates(ops)
        for sl, _ in plain._sched.plan(len(kind)):
            oracle_chunk(oracle, kind[sl], u[sl], v[sl])
        plain._apply_ops(kind, u, v)
        hist[plain.gen] = (oracle.ccid(), set(oracle.edges))
    assert plain.gen == svc.gen
    assert plain.state.ccid.tolist() == svc.state.ccid.tolist()
    last = {}
    for i, kind, qu, qv, values, gen in record:
        assert gen >= last.get(i, -1), f"reader {i} went backwards"
        last[i] = gen
        assert gen in hist, f"uncommitted generation {gen} observed"
        cc, edges = hist[gen]
        for a, b, got in zip(qu.tolist(), qv.tolist(), values):
            want = (cc[a] != NV and cc[a] == cc[b]) if kind == "same" \
                else (cc[a] != NV and cc[b] != NV and _reach(edges, a, b))
            assert got == want, (kind, gen, a, b)
    assert len({r[5] for r in record}) > 1, "readers saw one generation"


# ----------------------------------------------------- fault injection ----


def test_broker_stall_hook_fires():
    cfg = tiny_cfg()
    svc = SCCService(cfg, state=gs.all_singletons(cfg, "cpu"), **KNOBS)
    broker = QueryBroker(svc, buckets=(8,))
    plan = FaultPlan(stalls=(Stall("broker_flush", first=0, count=1,
                                   seconds=0.05),))
    with injected(plan):
        t0 = time.monotonic()
        snap = broker.resolve(broker.submit("same_scc", [0], [1]))
        assert time.monotonic() - t0 >= 0.045
    assert snap.gen == svc.gen and plan._stall_counts["broker_flush"] >= 1


def test_wal_fault_degrades_then_recovers_and_kills_fire(tmp_path):
    """A torn WAL write flips the writer to DEGRADED (reads keep serving,
    nothing applied); a healed disk re-attaches; a gen-scheduled replica
    kill fires once; recovery holds exactly the acknowledged history."""
    from repro_torch.ckpt.durable import DEGRADED, HEALTHY
    writer = make_writer(tmp_path)
    rng = np.random.default_rng(0)
    writer._apply_ops(*random_chunk(rng))
    gen0 = writer.gen
    plan = FaultPlan(fs=(FsFault("write", "wal", first=0, count=2,
                                 error="torn"),))
    with injected(plan):
        with pytest.raises(fault_errors.Unavailable):
            writer._apply_ops(*random_chunk(rng))
        assert writer.health == DEGRADED and writer.gen == gen0
        assert QueryBroker(writer).same_scc([0], [1]).gen == gen0
    ok, gen = writer._apply_ops(*random_chunk(rng))
    assert writer.health == HEALTHY and gen == gen0 + 1
    rs = ReplicaSet(str(tmp_path), 2, auto_tail=False, query_buckets=(8,),
                    device="cpu")
    kills = FaultPlan(kills=(ReplicaKill(replica_id=1, at_gen=gen),))
    assert fire_kills(kills, rs, writer_gen=gen - 1) == []
    assert fire_kills(kills, rs, writer_gen=gen) == [kills.kills[0]]
    assert not rs.replicas[1].healthy and rs.healthy_replicas == \
        [rs.replicas[0]]
    assert fire_kills(kills, rs, writer_gen=gen + 5) == []
    rs.stop()
    final = writer.state
    writer.close()
    rec = DurableService.open(str(tmp_path), device="cpu")
    assert rec.gen == gen and replica_launch.states_equal(rec.state, final)
    rec.close()


# ------------------------------------------------------- lease and HA ----


def acquire_stale(lease, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not lease.try_acquire():
        assert time.monotonic() < deadline, "lease never went stale"
        time.sleep(lease.ttl_s / 5)


def test_lease_acquire_takeover_and_fenced_writer(tmp_path):
    a = FileLease(str(tmp_path), "a", ttl_s=0.15)
    b = FileLease(str(tmp_path), "b", ttl_s=0.15)
    assert a.try_acquire() and a.epoch == 0
    assert not b.try_acquire()  # holder is alive
    writer = make_writer(tmp_path, lease=a)
    writer._apply_ops(*random_chunk(np.random.default_rng(5)))
    writer.crash()  # heartbeat stops, lease left behind
    acquire_stale(b)
    assert b.epoch == 1 and b.takeovers == 1
    with pytest.raises(fault_errors.LeaseLost):
        a.renew()
    with pytest.raises(fault_errors.NotLeader):
        writer._apply_ops(*random_chunk(np.random.default_rng(6)))
    assert writer.health == FENCED
    writer.close()


def test_promotion_is_a_bit_identical_next_epoch_handoff(tmp_path):
    cfg = tiny_cfg()
    lease_a = FileLease(str(tmp_path), "a", ttl_s=0.15)
    assert lease_a.try_acquire()
    writer = make_writer(tmp_path, lease=lease_a)
    rng = np.random.default_rng(11)
    chunks = [random_chunk(rng) for _ in range(5)]
    for c in chunks:
        writer._apply_ops(*c)
    writer.crash()
    rep = replica(tmp_path)
    lease_b = FileLease(str(tmp_path), "b", ttl_s=0.15)
    deadline = time.monotonic() + 5.0
    leader = None
    while leader is None:
        try:
            leader = rep.promote(lease_b, snapshot_every=0)
        except fault_errors.Unavailable:
            assert time.monotonic() < deadline, "promotion never won"
            time.sleep(0.03)
    try:
        assert leader.epoch == 1 and leader.gen == writer.gen
        more = [random_chunk(rng) for _ in range(3)]
        for c in more:
            leader._apply_ops(*c)
        with pytest.raises(fault_errors.NotLeader):
            writer._apply_ops(*random_chunk(rng))
        oracle = SCCService(cfg, state=gs.all_singletons(cfg, "cpu"),
                            **KNOBS)
        for c in chunks + more:
            oracle._apply_ops(*c)
        assert leader.gen == oracle.gen
        assert_same(leader, oracle, "promoted leader")
    finally:
        leader.close()
        rep.stop()
        writer.close()
    reopened = DurableService.open(str(tmp_path), snapshot_every=0,
                                   device="cpu")
    assert reopened.epoch >= 1 and reopened.gen == oracle.gen
    assert_same(reopened, oracle, "cold reopen")
    reopened.close()


def test_supervisor_promotes_on_stale_writer_lease(tmp_path):
    # a TTL well above a heartbeat's delay on a loaded host: the writer
    # must not look dead before it crashes
    lease = FileLease(str(tmp_path), "writer", ttl_s=0.5)
    assert lease.try_acquire()
    writer = make_writer(tmp_path, lease=lease)
    rng = np.random.default_rng(17)
    for _ in range(3):
        writer._apply_ops(*random_chunk(rng))
    rset = ReplicaSet(str(tmp_path), 2, query_buckets=(8,),
                      poll_interval=0.02, supervise=True,
                      health_check_s=0.03, promote_on_writer_loss=True,
                      lease_ttl_s=0.5, device="cpu",
                      writer_kwargs=dict(sync_every=1, snapshot_every=0))
    try:
        time.sleep(0.3)
        assert rset.leader is None and rset.promotions == 0  # writer alive
        writer.crash()
        deadline = time.monotonic() + 8.0
        while rset.leader is None:
            assert time.monotonic() < deadline, (
                f"supervisor never promoted ({rset.last_promote_error})")
            time.sleep(0.02)
        leader = rset.leader
        assert rset.promotions == 1 and leader.epoch == 1
        assert leader.device.type == "cpu"
        leader._apply_ops(*random_chunk(rng))
        assert leader.gen == writer.gen + 1
    finally:
        rset.stop()  # also closes the promoted leader
        writer.close()


def test_supervisor_restarts_killed_replica(tmp_path):
    writer = make_writer(tmp_path)
    writer._apply_ops(*random_chunk(np.random.default_rng(3)))
    rset = ReplicaSet(str(tmp_path), 2, query_buckets=(8,),
                      poll_interval=0.01, supervise=True,
                      health_check_s=0.02, device="cpu")
    try:
        victim = rset.replicas[0]
        victim.kill()
        deadline = time.monotonic() + 5.0
        while rset.restarts < 1 or len(rset.healthy_replicas) < 2:
            assert time.monotonic() < deadline, "no restart of the kill"
            time.sleep(0.01)
        assert rset.replicas[0] is not victim and rset.quarantined >= 1
        rset.wait_all_for_gen(writer.gen, timeout=5.0)
        fut = rset.submit("same_scc", [0], [1], min_gen=writer.gen)
        assert rset.resolve(fut, min_gen=writer.gen).gen >= writer.gen
    finally:
        rset.stop()
        writer.close()


# ------------------------------------------------------ entry points -----


def test_serve_readers_and_replicas_run_on_cpu(tmp_path):
    from repro_torch.launch import serve
    rep = serve.serve_smscc(2, nv=256, chunk=64, readers=2, device="cpu")
    assert rep["ops"] == 128 and rep["readers"] == 2
    assert rep["device"] == "cpu" and rep["queries"] > 0
    rep = serve.serve_smscc(4, replicas=2, directory=str(tmp_path),
                            device="cpu")
    assert rep["replicas"] == 2 and rep["ops"] == 128
    assert rep["queries"] > 0 and rep["touches"] > 0
    with pytest.raises(SystemExit, match="--dir"):
        serve.serve_smscc(4, replicas=2, device="cpu")


def _cli(*args, **kw):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.replica", *args,
         "--device", "cpu"], env=env, text=True, **kw)


def test_writer_child_sigkill_then_both_recovery_paths_agree(tmp_path):
    """The crash smoke: the CLI's writer child is SIGKILLed mid-stream;
    the store recovers, and snapshot + tail equals scratch replay."""
    d = str(tmp_path)
    p = _cli("--writer-child", "--dir", d, "--nv", "64", "--chunk", "16",
             "--snapshot-every", "3", stdout=subprocess.PIPE)
    try:
        gens = []
        for line in p.stdout:
            gens.append(int(line.split()[1]))
            if len(gens) >= 6:
                break
    finally:
        p.send_signal(signal.SIGKILL)
        p.wait(timeout=30)
        p.stdout.close()
    assert gens == sorted(gens) and gens[-1] >= 6
    summary = replica_launch.verify_recovery(d, device="cpu")
    assert summary["gen"] >= gens[-1]


def test_supervised_replica_children_converge_after_a_kill(tmp_path):
    summary = replica_launch.supervised_stream(
        str(tmp_path), replicas=2, steps=8, chunk=24, nv=96, pace_s=0.05,
        kill_child_after=0.1, child_wait_s=60.0, device="cpu")
    assert summary == {"replicas": 2, "gen": 8, "killed": 1,
                       "restarts": summary["restarts"]}
    assert summary["restarts"] >= 1
