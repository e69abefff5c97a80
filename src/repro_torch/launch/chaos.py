"""Chaos soak: recorded op stream under a seeded fault plan (a port of
``repro.launch.chaos``; every role runs on ``cuda`` unless ``--device``
says otherwise).

The durability suite proves recovery from a *single* crash point; this
driver holds the serving stack's failure-domain contract under a whole
schedule of faults injected **while serving** (:mod:`repro_torch.fault`):
WAL write/fsync faults (EIO / ENOSPC / torn records) that flip the
writer DEGRADED mid-stream, and replica kills that force query failover
and supervisor restarts.  One soak run asserts, for a seeded
:class:`~repro_torch.fault.inject.FaultPlan`:

* **no acked op is ever lost** -- the writer's final state is
  bit-identical to an in-memory oracle replaying exactly the
  acknowledged chunks, and so is a cold :meth:`DurableService.open` of
  the store afterwards (a chunk the client saw fail was never applied;
  a chunk the client saw ack survives every injected fault);
* **every failure is typed** -- a client only ever observes
  :class:`~repro_torch.fault.errors.FaultError` subclasses (``Unavailable``,
  ``DeadlineExceeded``, ...); any bare exception is a violation;
* **availability never reaches zero while a replica is healthy** -- a
  per-round query probe through the :class:`ReplicaSet` must keep
  answering (transparent failover + supervisor restarts) whenever at
  least one replica is routable;
* **the store heals under fire** -- the plan's fault windows are
  finite, so the writer's rate-limited recovery probes must re-attach
  the WAL and return to HEALTHY *while the plan is still armed*.

Determinism: the fault *schedule* is a pure function of (seed,
profile) and fires on call/generation counters, not wall clock, so a
failing seed reproduces (thread interleavings still vary, but every
assertion above is interleaving-independent).

``--failover`` runs the writer-loss soak (:func:`run_writer_failover`):
SIGKILL-equivalent crash of the *leased* writer mid-stream, after which
the :class:`ReplicaSet` supervisor must promote a replica (lease
takeover bumps the WAL epoch and fences the dead writer's log), the
client must reroute on ``NotLeader`` and keep acking, no acked op may
be lost across the handoff (oracle replay bit-identical), and a
resurrected old-epoch writer must be refused with **nothing written**
(no split brain).  ``--tenant-soak`` holds the same zero-acked-loss /
typed-errors-only contract per tenant while disk faults bite the
per-tenant WAL dirs of a :class:`MultiTenantService`.

``--availability`` runs the companion windowed bench
(:func:`run_availability`): closed-loop query throughput in a steady
window vs a window where a replica is killed and supervisor-restarted,
then closed-loop *write* throughput in a steady window vs a window
where the leased writer is crashed and a replica promoted; ``main``
gates both ratios at 0.5.

Each run's oracle is a plain :class:`SCCService` replaying exactly the
acknowledged chunks on the same device, held leaf for leaf
(:func:`repro_torch.launch.replica.states_equal`).  Each report also
carries its ``ledger`` (the acknowledged chunks, in order) and the final
state(s), so a caller can replay the ledger elsewhere -- through the JAX
package, say -- and compare.
"""
from __future__ import annotations

import argparse
import itertools
import os
import sys
import tempfile
import time

from repro_torch.core import graph_state as gs

__all__ = ["run_chaos_soak", "run_writer_failover", "run_tenant_soak",
           "run_availability"]


def run_chaos_soak(directory: str, *, seed: int = 0,
                   profile: str = "mixed", n_chunks: int = 40,
                   chunk: int = 16, nv: int = 192, replicas: int = 2,
                   poll_interval: float = 0.02, n_queries: int = 8,
                   deadline_s: float = 8.0, device=gs.DEFAULT_DEVICE) -> dict:
    """One soak run; returns a report dict whose ``violations`` list is
    empty iff every contract held (the driver never raises for a fault
    outcome -- only for harness bugs)."""
    import numpy as np

    from repro_torch.api import GraphClient, SameSCC
    from repro_torch.api.ops import encode_updates
    from repro_torch.ckpt.durable import DurableService, HEALTHY
    from repro_torch.core.replicas import ReplicaSet
    from repro_torch.core.service import SCCService
    from repro_torch.fault import errors as fault_errors
    from repro_torch.fault.inject import FaultPlan, fire_kills, injected
    from repro_torch.launch.replica import _writer_config, states_equal
    from repro_torch.launch.stream import typed_op_stream

    cfg = _writer_config(nv, edge_capacity=2048)
    writer = DurableService(
        cfg, directory, state=gs.all_singletons(cfg, device),
        buckets=(chunk,),
        proactive_grow=True, sync_every=1, segment_bytes=16 << 10,
        snapshot_every=8, snapshot_keep=4, recover_probe_s=0.01)
    rset = ReplicaSet(directory, replicas, query_buckets=(n_queries,),
                      poll_interval=poll_interval, supervise=True,
                      health_check_s=0.05, device=device)
    wclient = GraphClient(writer, deadline_s=deadline_s, max_retries=64,
                          backoff_base_s=0.002, backoff_cap_s=0.05)
    rclient = GraphClient(writer, broker=rset, deadline_s=deadline_s,
                          max_retries=16, backoff_base_s=0.002,
                          backoff_cap_s=0.05)
    rng = np.random.default_rng(seed + 101)

    acked: list = []  # the ledger the oracle replays
    failed: list = []
    violations: list = []

    # warm the compiled update/query paths off the fault clock -- the
    # warm chunk is acked, so it joins the ledger like any other
    warm = typed_op_stream(nv, chunk, step=1 << 20, add_frac=0.7,
                           seed=seed)
    wclient.submit_many(warm)
    acked.append(warm)
    rclient.submit_many([SameSCC(0, 1)] * n_queries)

    plan = FaultPlan.generate(seed, profile, replicas=replicas,
                              horizon_gens=n_chunks)
    probe_ok = probe_fail = 0
    with injected(plan):
        for step in range(n_chunks):
            ops = typed_op_stream(nv, chunk, step=step, add_frac=0.7,
                                  seed=seed)
            try:
                wclient.submit_many(ops)
                acked.append(ops)
            except fault_errors.FaultError as e:
                failed.append(type(e).__name__)  # typed reject: fine
            except Exception as e:  # contract breach: must be typed
                failed.append(type(e).__name__)
                violations.append(
                    f"untyped writer failure at step {step}: "
                    f"{type(e).__name__}: {e}")
            fire_kills(plan, rset, writer.gen)
            qu = rng.integers(0, nv, n_queries)
            qv = rng.integers(0, nv, n_queries)
            try:
                rclient.submit_many([SameSCC(int(a), int(b))
                                     for a, b in zip(qu, qv)])
                probe_ok += 1
            except fault_errors.FaultError:
                probe_fail += 1
                if rset.healthy_replicas:
                    violations.append(
                        f"query probe failed at step {step} with "
                        f"{len(rset.healthy_replicas)} healthy replicas")
            except Exception as e:
                probe_fail += 1
                violations.append(
                    f"untyped reader failure at step {step}: "
                    f"{type(e).__name__}: {e}")
        # heal under fire: fault windows are finite counters, so
        # repeated probes must re-attach the WAL with the plan armed
        heal_deadline = time.monotonic() + 10.0
        while writer.health != HEALTHY and \
                time.monotonic() < heal_deadline:
            writer.probe_recovery()
            time.sleep(0.01)
        if writer.health != HEALTHY:
            violations.append(
                "store did not recover after the fault window "
                f"(stuck on: {writer._degraded_error})")

    final_gen = writer.gen
    final_state = writer.state
    writer_stats = writer.stats()
    try:
        rset.wait_all_for_gen(final_gen, timeout=10.0)
        rs_stats = rset.stats()
        rset.stop()
    except Exception as e:
        rs_stats = {"failovers": -1, "restarts": -1}
        violations.append(
            f"replica teardown raised: {type(e).__name__}: {e}")
    writer.close()

    # oracle: replay exactly the acked chunks through a plain in-memory
    # service with the writer's decision knobs -- acked ops and nothing
    # else must reproduce the writer bit-for-bit
    oracle = SCCService(cfg, state=gs.all_singletons(cfg, device),
                        buckets=(chunk,), proactive_grow=True)
    for ops in acked:
        kind, u, v = encode_updates(ops)
        oracle._apply_ops(kind, u, v)
    if oracle.gen != final_gen:
        violations.append(
            f"acked-op oracle at gen {oracle.gen}, writer at "
            f"{final_gen}: an op was lost or double-applied")
    elif not states_equal(final_state, oracle.state):
        violations.append(
            "writer state diverged from the acked-op oracle")

    # cold disk recovery must land on the same state (plan disarmed:
    # this checks what the faults left on disk, not new faults)
    reopened = DurableService.open(directory, snapshot_every=0,
                                   device=device)
    if reopened.gen != oracle.gen:
        violations.append(
            f"disk recovery at gen {reopened.gen}, oracle at "
            f"{oracle.gen}: durability lost an acked op")
    elif not states_equal(reopened.state, oracle.state):
        violations.append(
            "disk recovery diverged from the acked-op oracle")
    reopened.close()

    return {
        "seed": seed, "profile": profile,
        "chunks": n_chunks + 1, "acked": len(acked),
        "failed": failed, "gen": final_gen,
        "fs_faults_planned": len(plan.fs),
        "fs_triggered": len(plan.triggered),
        "kills_planned": len(plan.kills),
        "kills_fired": len(plan._fired_kills),
        "probe_ok": probe_ok, "probe_fail": probe_fail,
        "degraded": writer_stats["degraded_count"],
        "recovered": writer_stats["recovered_count"],
        "rejects": writer_stats["unavailable_rejects"],
        "client_retries": wclient.retries + rclient.retries,
        "failovers": rs_stats["failovers"],
        "restarts": rs_stats["restarts"],
        "violations": violations,
        "ledger": acked, "final_state": final_state,
    }


def run_writer_failover(directory: str, *, seed: int = 0,
                        n_chunks: int = 24, chunk: int = 16,
                        nv: int = 192, replicas: int = 2,
                        lease_ttl_s: float = 0.2,
                        poll_interval: float = 0.02,
                        deadline_s: float = 20.0,
                        device=gs.DEFAULT_DEVICE) -> dict:
    """Writer-loss soak: crash the leased writer mid-stream and hold the
    high-availability contract end to end.

    The writer holds a :class:`~repro.ha.lease.FileLease`; its WAL epoch
    *is* the fencing token.  ``crash()`` is the in-process analogue of
    ``kill -9``: the heartbeat stops dead, nothing is released.  The
    supervisor must then notice the stale lease, promote the most
    caught-up replica (takeover bumps the epoch and fences the old log),
    and the client -- rerouted via ``leader_resolver`` on ``NotLeader``
    -- must keep acking ops.  Violations:

    * no promotion, or zero writes acked after the kill;
    * the promoted leader's epoch did not exceed the dead writer's;
    * an untyped client error during the handoff;
    * oracle replay of exactly the acked chunks (old leader's and new
      leader's alike) differs from the final leader state, or from a
      cold :meth:`DurableService.open` of the store;
    * a resurrected writer at the dead epoch is *not* refused, or the
      refusal left any byte behind in the WAL directory.
    """
    import random as _random

    import numpy as np

    from repro_torch.api import GraphClient
    from repro_torch.api.ops import encode_updates
    from repro_torch.ckpt import oplog
    from repro_torch.ckpt.durable import DurableService, wal_dir
    from repro_torch.core.replicas import ReplicaSet
    from repro_torch.core.service import SCCService
    from repro_torch.fault import errors as fault_errors
    from repro_torch.ha.lease import FileLease
    from repro_torch.launch.replica import _writer_config, states_equal
    from repro_torch.launch.stream import typed_op_stream

    cfg = _writer_config(nv, edge_capacity=2048)
    lease = FileLease(directory, owner=f"writer-{os.getpid()}",
                      ttl_s=lease_ttl_s)
    assert lease.try_acquire(), "fresh store: first acquire cannot lose"
    writer = DurableService(
        cfg, directory, state=gs.all_singletons(cfg, device),
        buckets=(chunk,),
        proactive_grow=True, sync_every=1, segment_bytes=16 << 10,
        snapshot_every=8, snapshot_keep=4, lease=lease)
    rset = ReplicaSet(directory, replicas, query_buckets=(8,),
                      poll_interval=poll_interval, supervise=True,
                      health_check_s=0.05, promote_on_writer_loss=True,
                      lease_ttl_s=lease_ttl_s,
                      writer_kwargs=dict(sync_every=1,
                                         segment_bytes=16 << 10,
                                         snapshot_every=0),
                      device=device)
    client = GraphClient(writer, deadline_s=deadline_s, max_retries=400,
                         backoff_base_s=0.002, backoff_cap_s=0.05,
                         rng=_random.Random(seed),
                         leader_resolver=lambda: rset.leader)

    acked: list = []
    failed: list = []
    violations: list = []

    warm = typed_op_stream(nv, chunk, step=1 << 20, add_frac=0.7,
                           seed=seed)
    client.submit_many(warm)
    acked.append(warm)

    kill_step = max(2, n_chunks // 3)
    old_epoch = writer.epoch
    post_kill_acked = 0
    for step in range(n_chunks):
        if step == kill_step:
            writer.crash()  # kill -9: heartbeat stops, nothing released
        ops = typed_op_stream(nv, chunk, step=step, add_frac=0.7,
                              seed=seed)
        try:
            client.submit_many(ops)
            acked.append(ops)
            if step >= kill_step:
                post_kill_acked += 1
        except fault_errors.FaultError as e:
            failed.append(type(e).__name__)  # typed reject: fine
        except Exception as e:  # contract breach: must be typed
            failed.append(type(e).__name__)
            violations.append(
                f"untyped client failure at step {step}: "
                f"{type(e).__name__}: {e}")

    leader = rset.leader
    if rset.promotions < 1 or leader is None:
        violations.append(
            f"writer loss never promoted a replica (promotions="
            f"{rset.promotions}, last_error={rset.last_promote_error})")
    if post_kill_acked == 0:
        violations.append("no write was acked after the writer kill: "
                          "write availability reached zero")
    if leader is not None and leader.epoch <= old_epoch:
        violations.append(
            f"promoted leader epoch {leader.epoch} does not fence the "
            f"dead writer's epoch {old_epoch}")

    final = leader if leader is not None else writer
    final_gen, final_state = final.gen, final.state
    writer_stats = writer.stats()
    rs_stats = rset.stats()

    # split-brain probe: resurrect the dead writer at its old epoch --
    # the fence must refuse it with nothing written
    wdir = wal_dir(directory)

    def wal_listing():
        return sorted((name, os.path.getsize(os.path.join(wdir, name)))
                      for name in os.listdir(wdir))

    before = wal_listing()
    try:
        zombie = oplog.OpLogWriter(wdir, start_gen=final_gen,
                                   epoch=old_epoch)
        zombie.close()
        violations.append(
            "resurrected old-epoch writer was NOT fenced: split brain")
    except fault_errors.Fenced:
        pass
    if wal_listing() != before:
        violations.append("the fenced resurrect probe left bytes "
                          "behind in the WAL directory")

    # oracle: exactly the acked chunks -- across both leaders -- must
    # reproduce the final leader bit-for-bit (exactly-once handoff)
    oracle = SCCService(cfg, state=gs.all_singletons(cfg, device),
                        buckets=(chunk,), proactive_grow=True)
    for ops in acked:
        kind, u, v = encode_updates(ops)
        oracle._apply_ops(kind, u, v)
    if oracle.gen != final_gen:
        violations.append(
            f"acked-op oracle at gen {oracle.gen}, leader at "
            f"{final_gen}: an op was lost or double-applied across "
            f"the handoff")
    elif not states_equal(final_state, oracle.state):
        violations.append(
            "leader state diverged from the acked-op oracle")

    try:
        rset.stop()  # also closes the promoted leader
    except Exception as e:
        violations.append(
            f"replica teardown raised: {type(e).__name__}: {e}")
    writer.close()

    reopened = DurableService.open(directory, snapshot_every=0,
                                   device=device)
    if reopened.gen != oracle.gen:
        violations.append(
            f"disk recovery at gen {reopened.gen}, oracle at "
            f"{oracle.gen}: durability lost an acked op")
    elif not states_equal(reopened.state, oracle.state):
        violations.append(
            "disk recovery diverged from the acked-op oracle")
    if reopened.epoch <= old_epoch:
        violations.append(
            f"cold reopen adopted epoch {reopened.epoch}, expected a "
            f"fenced epoch above {old_epoch}")
    reopened.close()

    return {
        "seed": seed, "chunks": n_chunks + 1, "acked": len(acked),
        "failed": failed, "gen": final_gen,
        "old_epoch": old_epoch, "new_epoch": final.epoch,
        "post_kill_acked": post_kill_acked,
        "promotions": rs_stats["promotions"],
        "promote_failures": rs_stats["promote_failures"],
        "notleader_rejects": writer_stats["notleader_rejects"],
        "client_retries": client.retries,
        "client_reroutes": client.stats()["client_reroutes"],
        "violations": violations,
        "ledger": acked, "final_state": final_state,
    }


def run_tenant_soak(directory: str, *, seed: int = 0, tenants: int = 3,
                    n_rounds: int = 20, chunk: int = 8, nv: int = 96,
                    deadline_s: float = 8.0, device=gs.DEFAULT_DEVICE) -> dict:
    """Per-tenant WAL fault soak: a seeded ``disk-fault`` plan bites the
    per-tenant WAL dirs (``<dir>/tenants/<tid>/wal``) of a
    :class:`MultiTenantService` while every tenant streams ops.  Holds,
    *per tenant*: a failed lane is a typed retryable reject (never a
    bare exception, never an ack), the surviving lanes of the same wave
    flush normally, and afterwards both the live tenant state and a cold
    per-tenant :meth:`DurableService.open` are bit-identical to an
    oracle replaying exactly that tenant's acked chunks."""
    import numpy as np

    from repro_torch.api.ops import encode_updates
    from repro_torch.ckpt.durable import DurableService
    from repro_torch.core.service import SCCService
    from repro_torch.fault import errors as fault_errors
    from repro_torch.fault.inject import FaultPlan, injected
    from repro_torch.launch.replica import _writer_config, states_equal
    from repro_torch.launch.stream import typed_op_stream
    from repro_torch.tenancy import MultiTenantService

    cfg = _writer_config(nv, edge_capacity=512)
    knobs = dict(buckets=(chunk,), scan_lengths=(1,))
    mts = MultiTenantService(cfg, directory=directory,
                             tenant_batches=(1, 2, max(2, tenants)),
                             coalesce_ops=tenants * chunk,
                             flush_deadline_s=0.0, wal_sync_every=1,
                             device=device, **knobs)
    tids = [mts.create_tenant() for _ in range(tenants)]
    clients = {tid: mts.client(tid, deadline_s=deadline_s,
                               max_retries=64, backoff_base_s=0.002,
                               backoff_cap_s=0.05)
               for tid in tids}
    acked = {tid: [] for tid in tids}
    failed: list = []
    violations: list = []

    for i, tid in enumerate(tids):  # warm off the fault clock
        warm = typed_op_stream(nv, chunk, step=1 << 20, add_frac=0.7,
                               seed=seed + i)
        clients[tid].submit_many(warm)
        acked[tid].append(warm)

    plan = FaultPlan.generate(seed, "disk-fault", horizon_gens=n_rounds)
    with injected(plan):
        for rnd in range(n_rounds):
            for i, tid in enumerate(tids):
                ops = typed_op_stream(nv, chunk, step=rnd, add_frac=0.7,
                                      seed=seed + i)
                try:
                    clients[tid].submit_many(ops)
                    acked[tid].append(ops)
                except fault_errors.FaultError as e:
                    failed.append((tid, type(e).__name__))
                except Exception as e:
                    failed.append((tid, type(e).__name__))
                    violations.append(
                        f"untyped tenant failure round {rnd} tenant "
                        f"{tid}: {type(e).__name__}: {e}")
    mts.flush()
    stats = mts.stats()
    wal_faults = sum(t["wal_faults"]
                     for t in stats["per_tenant"].values())
    live = {tid: (mts._tenant_state(tid), mts.tenant_gen(tid))
            for tid in tids}
    mts.close()

    for i, tid in enumerate(tids):
        oracle = SCCService(cfg, device=device, **knobs)
        for ops in acked[tid]:
            kind, u, v = encode_updates(ops)
            oracle._apply_ops(kind, u, v)
        state, gen_live = live[tid]
        if oracle.gen != gen_live:
            violations.append(
                f"tenant {tid} live gen {gen_live} != acked-op oracle "
                f"gen {oracle.gen}: an op was lost or double-applied")
        elif not states_equal(state, oracle.state):
            violations.append(
                f"tenant {tid} live state diverged from its "
                f"acked-op oracle")
        d = DurableService.open(
            os.path.join(directory, "tenants", tid), snapshot_every=0,
            device=device)
        if d.gen != oracle.gen:
            violations.append(
                f"tenant {tid} disk recovery gen {d.gen} != oracle "
                f"gen {oracle.gen}: durability lost an acked op")
        elif not states_equal(d.state, oracle.state):
            violations.append(
                f"tenant {tid} disk recovery diverged from "
                f"its acked-op oracle")
        d.close()

    return {
        "seed": seed, "tenants": tenants, "rounds": n_rounds,
        "acked": sum(len(v) for v in acked.values()),
        "failed": failed, "wal_faults": wal_faults,
        "fs_faults_planned": len(plan.fs),
        "fs_triggered": len(plan.triggered),
        "violations": violations,
        "ledger": acked,
        "final_states": {tid: st for tid, (st, _) in live.items()},
    }


def run_availability(directory: str | None = None, *,
                     replicas: int = 2, nv: int = 256, chunk: int = 32,
                     preload_chunks: int = 8, n_queries: int = 32,
                     window_s: float = 0.8,
                     write_window_s: float | None = None,
                     lease_ttl_s: float = 0.12,
                     poll_interval: float = 0.02,
                     seed: int = 0, device=gs.DEFAULT_DEVICE) -> dict:
    """Windowed availability bench: closed-loop query throughput in a
    steady window vs a window opened by killing a replica (the
    supervisor restarts it mid-window), then closed-loop *write*
    throughput in a steady window vs a window opened by crashing the
    leased writer (the supervisor promotes a replica mid-window and the
    client reroutes on ``NotLeader``).  A closed-loop caller is
    latency-bound, so the read ratio should stay near 1.0; the write
    ratio pays one lease TTL of dead air and should stay well above
    0.5 for windows comfortably longer than the TTL.  ``ci.sh`` gates
    ``ratio >= 0.5`` and ``write_availability >= 0.5``."""
    import random as _random
    import shutil

    import numpy as np

    from repro_torch.api import GraphClient, SameSCC
    from repro_torch.ckpt.durable import DurableService
    from repro_torch.core.replicas import ReplicaSet
    from repro_torch.fault import errors as fault_errors
    from repro_torch.ha.lease import FileLease
    from repro_torch.launch.replica import _writer_config
    from repro_torch.launch.stream import typed_op_stream

    owns_dir = directory is None
    if owns_dir:
        directory = tempfile.mkdtemp(prefix="scc-avail-")
    if write_window_s is None:
        # promotion costs a lease TTL plus the takeover itself
        # (fence + tail drain + service ctor, ~0.3-0.7s): the window
        # must dwarf that dead air for the ratio to measure steady
        # rerouted throughput, not takeover latency
        write_window_s = max(window_s, 2.0)
    cfg = _writer_config(nv, edge_capacity=2048)
    lease = FileLease(directory, owner=f"writer-{os.getpid()}",
                      ttl_s=lease_ttl_s)
    assert lease.try_acquire(), "fresh store: first acquire cannot lose"
    writer = DurableService(
        cfg, directory, state=gs.all_singletons(cfg, device),
        buckets=(chunk,),
        proactive_grow=True, sync_every=1, snapshot_every=0,
        lease=lease)
    rset = ReplicaSet(directory, replicas, query_buckets=(n_queries,),
                      poll_interval=poll_interval, supervise=True,
                      health_check_s=0.05, promote_on_writer_loss=True,
                      lease_ttl_s=lease_ttl_s,
                      writer_kwargs=dict(sync_every=1, snapshot_every=0),
                      device=device)
    wclient = GraphClient(writer, deadline_s=8.0, max_retries=800,
                          backoff_base_s=0.002, backoff_cap_s=0.05,
                          rng=_random.Random(seed),
                          leader_resolver=lambda: rset.leader)
    for step in range(preload_chunks):
        wclient.submit_many(typed_op_stream(nv, chunk, step=step,
                                            add_frac=0.7, seed=seed))
    rclient = GraphClient(writer, broker=rset, deadline_s=4.0,
                          max_retries=16)
    rng = np.random.default_rng(seed + 11)
    batch = [SameSCC(int(a), int(b))
             for a, b in zip(rng.integers(0, nv, n_queries),
                             rng.integers(0, nv, n_queries))]
    rclient.submit_many(batch)  # compile warmup off the clock

    def window(duration: float):
        served = faults = 0
        t_end = time.perf_counter() + duration
        while time.perf_counter() < t_end:
            try:
                rclient.submit_many(batch)
                served += n_queries
            except fault_errors.FaultError:
                faults += 1
        return served, faults

    wstep = preload_chunks  # distinct op streams past the preload

    def write_window(duration: float):
        nonlocal wstep
        written = faults = 0
        t_end = time.perf_counter() + duration
        while time.perf_counter() < t_end:
            try:
                wclient.submit_many(typed_op_stream(
                    nv, chunk, step=wstep, add_frac=0.7, seed=seed))
                written += chunk
            except fault_errors.FaultError:
                faults += 1
            wstep += 1
        return written, faults

    try:
        steady_q, steady_faults = window(window_s)
        rset.replicas[0].kill()
        faulted_q, faulted_faults = window(window_s)
        steady_w, steady_wfaults = write_window(write_window_s)
        writer.crash()  # kill -9 the leader: promotion happens in-window
        faulted_w, faulted_wfaults = write_window(write_window_s)
        stats = rset.stats()
    finally:
        rset.stop()  # also closes a promoted leader
        writer.close()
        if owns_dir:
            shutil.rmtree(directory, ignore_errors=True)
    steady = steady_q / window_s
    faulted = faulted_q / window_s
    w_steady = steady_w / write_window_s
    w_faulted = faulted_w / write_window_s
    return {
        "replicas": replicas, "window_s": window_s,
        "steady_per_s": int(steady), "faulted_per_s": int(faulted),
        "ratio": round(faulted / max(steady, 1e-9), 4),
        "steady_faults": steady_faults,
        "faulted_faults": faulted_faults,
        "failovers": stats["failovers"], "restarts": stats["restarts"],
        "write_window_s": write_window_s,
        "lease_ttl_s": lease_ttl_s,
        "write_steady_per_s": int(w_steady),
        "write_faulted_per_s": int(w_faulted),
        "write_availability": round(w_faulted / max(w_steady, 1e-9), 4),
        "write_steady_faults": steady_wfaults,
        "write_faulted_faults": faulted_wfaults,
        "promotions": stats["promotions"],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", default=None,
                    help="keep per-run stores under this root "
                         "(default: throwaway temp dirs)")
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--profiles", default="mixed",
                    help="comma list of disk-fault|replica-kill|mixed")
    ap.add_argument("--smoke", action="store_true",
                    help="small sizes for the CI gate")
    ap.add_argument("--chunks", type=int, default=None)
    ap.add_argument("--nv", type=int, default=None)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--availability", action="store_true",
                    help="run the availability-window bench instead")
    ap.add_argument("--failover", action="store_true",
                    help="writer-loss soak: crash the leased writer "
                         "per seed; require promotion, fencing, "
                         "rerouted writes, zero acked-op loss")
    ap.add_argument("--tenant-soak", action="store_true",
                    help="disk-fault soak over per-tenant WAL dirs of "
                         "the multi-tenant service")
    ap.add_argument("--device", default=gs.DEFAULT_DEVICE,
                    help="device of every service, replica and oracle "
                         "(default: the card)")
    args = ap.parse_args()
    dev = args.device
    if args.availability:
        rep = run_availability(replicas=args.replicas, device=dev)
        print("availability: " + " | ".join(f"{k}={v}"
                                            for k, v in rep.items()))
        if rep["ratio"] < 0.5:
            sys.exit("availability ratio below 0.5")
        if rep["write_availability"] < 0.5:
            sys.exit("write availability below 0.5")
        if rep["promotions"] < 1:
            sys.exit("writer crash never promoted a replica")
        return

    seeds = [int(s) for s in args.seeds.split(",") if s]
    if args.failover:
        bad = 0
        for seed in seeds:
            with tempfile.TemporaryDirectory(
                    prefix=f"scc-failover-s{seed}-") as d:
                rep = run_writer_failover(
                    d, seed=seed,
                    n_chunks=args.chunks or (18 if args.smoke else 36),
                    nv=args.nv or (160 if args.smoke else 384),
                    replicas=args.replicas, device=dev)
            print(f"seed={seed}: acked={rep['acked']} "
                  f"failed={len(rep['failed'])} gen={rep['gen']} "
                  f"epoch={rep['old_epoch']}->{rep['new_epoch']} "
                  f"post_kill_acked={rep['post_kill_acked']} "
                  f"promotions={rep['promotions']} "
                  f"notleader={rep['notleader_rejects']} "
                  f"reroutes={rep['client_reroutes']} "
                  f"violations={len(rep['violations'])}", flush=True)
            for v in rep["violations"]:
                print(f"  VIOLATION: {v}", flush=True)
            bad += len(rep["violations"])
        print(f"writer failover: {len(seeds)} runs, {bad} violations")
        sys.exit(1 if bad else 0)
    if args.tenant_soak:
        bad = fs_trig = 0
        for seed in seeds:
            with tempfile.TemporaryDirectory(
                    prefix=f"scc-tsoak-s{seed}-") as d:
                rep = run_tenant_soak(
                    d, seed=seed,
                    n_rounds=args.chunks or (14 if args.smoke else 28),
                    nv=args.nv or (96 if args.smoke else 192), device=dev)
            print(f"seed={seed}: tenants={rep['tenants']} "
                  f"acked={rep['acked']} failed={len(rep['failed'])} "
                  f"wal_faults={rep['wal_faults']} "
                  f"fs_triggered={rep['fs_triggered']} "
                  f"violations={len(rep['violations'])}", flush=True)
            for v in rep["violations"]:
                print(f"  VIOLATION: {v}", flush=True)
            bad += len(rep["violations"])
            fs_trig += rep["fs_triggered"]
        if fs_trig == 0:
            print("VIOLATION: no filesystem fault ever triggered "
                  "(tenant WAL injection is not biting)")
            bad += 1
        print(f"tenant soak: {len(seeds)} runs, {bad} violations")
        sys.exit(1 if bad else 0)
    profiles = [p for p in args.profiles.split(",") if p]
    nv = args.nv or (160 if args.smoke else 384)
    n_chunks = args.chunks or (28 if args.smoke else 64)
    bad = 0
    fs_trig = kills = 0
    for seed, profile in itertools.product(seeds, profiles):
        if args.dir:
            d = os.path.join(args.dir, f"s{seed}-{profile}")
            os.makedirs(d, exist_ok=True)
            rep = run_chaos_soak(d, seed=seed, profile=profile,
                                 n_chunks=n_chunks, nv=nv,
                                 replicas=args.replicas, device=dev)
        else:
            with tempfile.TemporaryDirectory(
                    prefix=f"scc-chaos-s{seed}-") as d:
                rep = run_chaos_soak(d, seed=seed, profile=profile,
                                     n_chunks=n_chunks, nv=nv,
                                     replicas=args.replicas, device=dev)
        print(f"seed={seed} profile={profile}: acked={rep['acked']} "
              f"failed={len(rep['failed'])} gen={rep['gen']} "
              f"fs_triggered={rep['fs_triggered']} "
              f"kills={rep['kills_fired']} degraded={rep['degraded']} "
              f"recovered={rep['recovered']} "
              f"retries={rep['client_retries']} "
              f"failovers={rep['failovers']} "
              f"restarts={rep['restarts']} "
              f"violations={len(rep['violations'])}", flush=True)
        for v in rep["violations"]:
            print(f"  VIOLATION: {v}", flush=True)
        bad += len(rep["violations"])
        fs_trig += rep["fs_triggered"]
        kills += rep["kills_fired"]
    if any(p in ("disk-fault", "mixed") for p in profiles) \
            and fs_trig == 0:
        print("VIOLATION: no filesystem fault ever triggered "
              "(injection is not biting)")
        bad += 1
    if any(p in ("replica-kill", "mixed") for p in profiles) \
            and kills == 0:
        print("VIOLATION: no replica kill ever fired")
        bad += 1
    n = len(seeds) * len(profiles)
    print(f"chaos soak: {n} runs, {bad} violations")
    if bad:
        sys.exit(1)


if __name__ == "__main__":
    main()
