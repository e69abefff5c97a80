"""Replicated serving driver: durable writer + N read replicas (a port of
``repro.launch.replica``; every role runs on ``cuda`` unless ``--device``
says otherwise).

Entry points:

* **default** -- a self-contained demo/bench core
  (:func:`run_replicated_stream`): a :class:`repro_torch.ckpt.durable.
  DurableService` writer ingests an *arrival-paced* (open-loop) update
  stream while closed-loop reader sessions run read-your-writes rounds
  against a :class:`repro_torch.core.replicas.ReplicaSet`: each round
  commits
  one small "touch" update through the writer, then queries at
  ``Consistency.AT_LEAST(max(token, last_gen))`` -- the session's RYW
  token joined with its monotone-reads floor.  The serving regime is
  latency-bound, not compute-bound: the touch write guarantees every
  read round must wait out the replication lag of *some* replica
  (replicas pull the WAL on a staggered fixed cadence), so the set's
  soonest-ticking member hides most of the lag -- expected freshness
  wait drops from ~poll/2 at one replica to ~poll/2N at N -- and
  serving throughput scales with replica count even on a single core.

* ``--writer-child`` -- the crash-injection smoke's victim process: an
  ingest-only durable writer that prints its committed generation per
  chunk; a harness (``tests/test_torch_replicas.py``) SIGKILLs it at an
  arbitrary moment.

* ``--verify-recovery`` -- recover the store
  (:meth:`DurableService.open` = latest snapshot + WAL tail) and check
  it bit-for-bit against the independent scratch oracle (generation-0
  boot snapshot + full WAL, :func:`repro_torch.ckpt.durable.
  scratch_replay`).

* ``--promote-after-crash`` -- the failover half of the crash smoke:
  after the harness SIGKILLs an ``--ha`` writer child (one that held a
  :class:`~repro_torch.ha.lease.FileLease`), wait out the lease TTL, take
  it
  over from a fresh :class:`Replica` (epoch bump + WAL fence + tail
  drain), append more chunks as the new epoch's leader, and prove a
  resurrected writer at the dead epoch is refused with nothing
  written.  ``--verify-recovery`` afterwards replays the resulting
  *mixed-epoch* WAL through both recovery paths.

* ``--supervised`` -- multi-process serving: the parent runs the durable
  writer and spawns ``--replicas`` child
  processes (each a ``--replica-child``: one :class:`Replica` tailing
  the shared store, reporting its generation until it reaches
  ``--until-gen``).  The parent is the process-level supervisor: a
  child that dies (e.g. the ``--kill-child-after`` SIGKILL injection)
  is restarted and fast-forwards from the newest snapshot -- the
  cross-process analogue of ``ReplicaSet(supervise=True)``.  The run
  fails unless every replica slot converges to the writer's final
  generation, restarts included.  On a card the parent builds the kernels
  before it spawns the children, so they load them instead of each
  starting ``nvcc``.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np

from repro_torch.core import graph_state as gs

__all__ = ["run_replicated_stream", "writer_child", "verify_recovery",
           "replica_child", "supervised_stream", "promote_after_crash",
           "states_equal"]


def _writer_config(nv: int, edge_capacity: int | None = None):
    from repro_torch.configs import smscc
    return smscc.config(n_vertices=nv,
                        edge_capacity=edge_capacity or max(1024, nv),
                        max_probes=64, max_outer=64, max_inner=128)


def _child_env() -> dict:
    """The parent's environment with this package's root on PYTHONPATH,
    so ``python -m repro_torch...`` children import the same code."""
    import repro_torch
    root = os.path.dirname(os.path.dirname(repro_torch.__file__))
    path = os.environ.get("PYTHONPATH")
    return {**os.environ,
            "PYTHONPATH": root + (os.pathsep + path if path else "")}


def run_replicated_stream(directory: str, *, replicas: int = 2,
                          n_ops: int = 640, chunk: int = 32,
                          pace_s: float = 0.080, readers: int = 2,
                          n_queries: int = 96, nv: int = 512,
                          poll_interval: float = 0.150,
                          sync_every: int = 1, seed: int = 0,
                          add_frac: float = 0.7,
                          device=gs.DEFAULT_DEVICE):
    """Paced replicated serving: returns a StreamReport.

    ``pace_s`` is the update arrival period (open-loop ingest: the
    writer never back-pressures the stream) and ``poll_interval`` the
    replicas' WAL pull cadence -- the replication-lag bottleneck the
    replica count hides.  Readers are closed-loop read-your-writes
    sessions: each round commits one touch write through the writer
    (RYW token), then queries the ReplicaSet at
    ``AT_LEAST(max(token, last_gen))``.  The floor is freshly
    committed, so some replica must pull the WAL past it before the
    round can complete: round latency = touch + replication wait +
    query, and the wait is where staggered replicas buy throughput
    (soonest tick ~poll/2N away instead of ~poll/2).  The combined
    floor also keeps per-reader stamps monotone across replicas --
    replicas can run *ahead* of the writer's committed generation (a
    WAL record is durable before the writer's own apply commits), so a
    writer-derived floor alone would not prevent a stamp regression
    when consecutive rounds land on differently-advanced replicas.
    """
    from repro_torch.api import (AddEdge, Consistency, GraphClient,
                                 RemoveEdge, SameSCC)
    from repro_torch.ckpt.durable import DurableService
    from repro_torch.core.replicas import ReplicaSet
    from repro_torch.launch.stream import StreamReport, typed_op_stream

    # provision capacity for the whole run: a growth step mid-run would
    # rehash on the writer AND every replica at once
    cfg = _writer_config(nv, edge_capacity=2048)
    writer = DurableService(
        cfg, directory, state=gs.all_singletons(cfg, device),
        buckets=(8, chunk), proactive_grow=True, sync_every=sync_every,
        snapshot_every=0)
    rset = ReplicaSet(directory, replicas, query_buckets=(n_queries,),
                      poll_interval=poll_interval, device=device)
    updater = GraphClient(writer)
    stop = threading.Event()
    q_counts = [0] * readers
    touch_counts = [0] * readers
    errors: list = []

    def reader(i: int):
        rclient = GraphClient(writer, broker=rset)  # reads -> replicas
        wclient = GraphClient(writer)               # session's own writes
        rng = np.random.default_rng(seed + 7919 * (i + 1))
        u0, v0 = 2 * i, 2 * i + 1
        flip = False
        last_gen = 0
        try:
            while not stop.is_set():
                op = RemoveEdge(u0, v0) if flip else AddEdge(u0, v0)
                flip = not flip
                token = wclient.submit_many([op])[0].gen
                touch_counts[i] += 1
                floor = max(token, last_gen)  # RYW + monotone-reads
                qu = rng.integers(0, nv, n_queries)
                qv = rng.integers(0, nv, n_queries)
                res = rclient.submit_many(
                    [SameSCC(int(a), int(b)) for a, b in zip(qu, qv)],
                    consistency=Consistency.AT_LEAST(floor))
                gen = res[0].gen
                if gen < floor:
                    raise AssertionError(
                        f"reader {i}: stamp {gen} below floor {floor}")
                last_gen = gen
                q_counts[i] += n_queries
        except Exception as e:
            errors.append(e)

    # warm-up off the clock: one stream chunk (bucket `chunk`), one touch
    # write (bucket 8), one replica-served query flush
    updater.submit_many(typed_op_stream(nv, chunk, step=1 << 20,
                                        add_frac=add_frac, seed=seed))
    warm_floor = GraphClient(writer).submit_many([AddEdge(0, 1)])[0].gen
    GraphClient(writer, broker=rset).submit_many(
        [SameSCC(0, 1)], consistency=Consistency.AT_LEAST(warm_floor))

    threads = [threading.Thread(target=reader, args=(i,), daemon=True)
               for i in range(readers)]
    applied = accepted = step = 0
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    try:
        next_due = t0
        while applied < n_ops:
            n = min(chunk, n_ops - applied)
            ops = typed_op_stream(nv, n, step=step, add_frac=add_frac,
                                  seed=seed)
            results = updater.submit_many(ops)
            accepted += sum(r.value for r in results)
            applied += n
            step += 1
            next_due += pace_s
            delay = next_due - time.perf_counter()
            if delay > 0 and applied < n_ops:
                time.sleep(delay)
    finally:
        stop.set()
        for t in threads:
            t.join()
        rs_stats = rset.stats()
        rset.stop()
        writer.close()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    queries = sum(q_counts)
    touches = sum(touch_counts)
    rep = StreamReport(
        replicas=replicas, readers=readers, ops=applied,
        accepted=accepted, touches=touches, queries=queries,
        wall_s=wall, pace_ms=pace_s * 1e3, poll_ms=poll_interval * 1e3,
        ops_per_s=applied / wall,
        queries_per_s=queries / wall,
        combined_per_s=(applied + touches + queries) / wall,
        routed_fresh=rs_stats["routed_fresh"],
        routed_stale=rs_stats["routed_stale"],
        replica_gen_waits=rs_stats["gen_waits"],
    )
    return rep


def writer_child(directory: str, *, nv: int = 256, steps: int = 10_000,
                 chunk: int = 64, seed: int = 0, pace_s: float = 0.0,
                 snapshot_every: int = 0, ha: bool = False,
                 lease_ttl_s: float = 0.5, device=gs.DEFAULT_DEVICE):
    """Crash-smoke victim: durable ingest loop, one 'gen <g>' line per
    committed chunk on stdout (the harness watches for progress, then
    SIGKILLs this process mid-stream).  ``ha=True`` makes it a *leased*
    writer: SIGKILL leaves a stale lease behind for
    :func:`promote_after_crash` to take over."""
    from repro_torch.api import GraphClient
    from repro_torch.ckpt.durable import DurableService
    from repro_torch.launch.stream import typed_op_stream

    lease = None
    if ha:
        from repro_torch.ha.lease import FileLease
        lease = FileLease(directory, owner=f"writer-{os.getpid()}",
                          ttl_s=lease_ttl_s)
        assert lease.try_acquire(), \
            "writer child could not take the lease (store not fresh?)"
    cfg = _writer_config(nv)
    svc = DurableService(
        cfg, directory, state=gs.all_singletons(cfg, device),
        buckets=(chunk,),
        proactive_grow=True, sync_every=1, segment_bytes=16 << 10,
        snapshot_every=snapshot_every, snapshot_keep=1_000_000,
        trim_on_snapshot=False, lease=lease)  # keep the full WAL: the
    #                              verifier's scratch oracle replays
    #                              from gen 0
    client = GraphClient(svc)
    for step in range(steps):
        ops = typed_op_stream(nv, chunk, step=step, add_frac=0.7,
                              seed=seed)
        client.submit_many(ops)
        print(f"gen {svc.gen}", flush=True)
        if pace_s:
            time.sleep(pace_s)


def replica_child(directory: str, *, replica_id: int = 0,
                  until_gen: int = 0, duration_s: float = 120.0,
                  poll_interval: float = 0.05,
                  device=gs.DEFAULT_DEVICE) -> int:
    """Out-of-process replica: tail the store at ``directory``, report
    ``replica <id> gen <g>`` lines, exit 0 once ``until_gen`` is
    reached (3 on the ``duration_s`` safety timeout).  The supervised
    parent SIGKILLs / restarts these at will."""
    from repro_torch.core.replicas import Replica

    rep = Replica(directory, replica_id, query_buckets=(8,),
                  poll_interval=poll_interval, device=device)
    deadline = time.monotonic() + duration_s
    code = 3
    try:
        while time.monotonic() < deadline:
            print(f"replica {replica_id} gen {rep.gen}", flush=True)
            if rep.gen >= until_gen:
                code = 0
                break
            time.sleep(poll_interval)
    finally:
        rep.stop()
    return code


def supervised_stream(directory: str, *, replicas: int = 2,
                      steps: int = 48, chunk: int = 24, nv: int = 192,
                      pace_s: float = 0.08, seed: int = 0,
                      kill_child_after: float | None = None,
                      child_wait_s: float = 90.0,
                      max_restarts_per_slot: int = 3,
                      device=gs.DEFAULT_DEVICE) -> dict:
    """Supervised multi-process serving: parent writer + N replica
    child processes, restart-on-death; returns a summary dict, raises
    AssertionError when a slot fails to converge (restarts exhausted or
    safety timeout)."""
    from repro_torch.api import GraphClient
    from repro_torch.ckpt.durable import DurableService
    from repro_torch.launch.stream import typed_op_stream

    if str(device).startswith("cuda"):
        from repro_torch.kernels import _build
        _build.build()  # once here, not once per child
    cfg = _writer_config(nv, edge_capacity=2048)
    writer = DurableService(
        cfg, directory, state=gs.all_singletons(cfg, device),
        buckets=(chunk,), proactive_grow=True, sync_every=1,
        segment_bytes=32 << 10, snapshot_every=16)
    client = GraphClient(writer)
    final_gen = steps  # one committed generation per chunk

    def spawn(slot: int) -> subprocess.Popen:
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.replica",
             "--replica-child", "--id", str(slot), "--dir", directory,
             "--until-gen", str(final_gen),
             "--duration", str(child_wait_s), "--device", str(device)],
            env=_child_env())

    children = [spawn(i) for i in range(replicas)]
    restarts = [0] * replicas
    kill_at = None if kill_child_after is None \
        else time.monotonic() + kill_child_after
    killed = False

    def reap():
        """Restart any child that died without reaching the target (a
        clean exit 0 means it converged and is done)."""
        for i, p in enumerate(children):
            rc = p.poll()
            if rc is None or rc == 0:
                continue
            if restarts[i] >= max_restarts_per_slot:
                raise AssertionError(
                    f"replica slot {i} died with rc={rc} and is out of "
                    f"restarts")
            restarts[i] += 1
            children[i] = spawn(i)

    try:
        for step in range(steps):
            client.submit_many(typed_op_stream(
                nv, chunk, step=step, add_frac=0.7, seed=seed))
            if kill_at is not None and not killed \
                    and time.monotonic() >= kill_at:
                os.kill(children[0].pid, signal.SIGKILL)
                killed = True
            reap()
            time.sleep(pace_s)
        assert writer.gen == final_gen, (writer.gen, final_gen)
        # children converge on their own once the last record is
        # durable; keep supervising (a late SIGKILL race is restarted)
        deadline = time.monotonic() + child_wait_s
        while time.monotonic() < deadline:
            reap()
            if all(p.poll() == 0 for p in children):
                break
            time.sleep(0.1)
        codes = [p.poll() for p in children]
        if any(c != 0 for c in codes):
            raise AssertionError(
                f"replica children did not converge to gen "
                f"{final_gen}: exit codes {codes}")
    finally:
        for p in children:
            if p.poll() is None:
                p.kill()
                p.wait()
        writer.close()
    if kill_child_after is not None and sum(restarts) == 0:
        raise AssertionError(
            "SIGKILL was injected but no child restart happened")
    return {"replicas": replicas, "gen": final_gen,
            "killed": int(killed), "restarts": sum(restarts)}


def states_equal(a, b) -> bool:
    """Two GraphStates hold the same leaves: same keys, dtypes, shapes
    and values (devices may differ)."""
    from repro_torch.ckpt.checkpoint import leaves
    la, lb = list(leaves(a)), list(leaves(b))
    return [k for k, _ in la] == [k for k, _ in lb] and all(
        x.dtype == y.dtype and x.shape == y.shape
        and bool((x.cpu() == y.cpu()).all())
        for (_, x), (_, y) in zip(la, lb))


def verify_recovery(directory: str, device=gs.DEFAULT_DEVICE) -> dict:
    """Recover the (possibly crash-torn) store and prove the two
    independent recovery paths agree bit-for-bit; returns a summary
    dict, raises on any divergence."""
    from repro_torch.ckpt.durable import DurableService, scratch_replay

    recovered = DurableService.open(directory, snapshot_every=0,
                                    device=device)
    oracle = scratch_replay(directory, device=device)
    if recovered.gen != oracle.gen:
        raise AssertionError(
            f"recovery diverged: snapshot+tail at gen {recovered.gen}, "
            f"scratch replay at gen {oracle.gen}")
    if not states_equal(recovered.state, oracle.state):
        raise AssertionError("recovery diverged: state leaves differ")
    summary = {"gen": recovered.gen,
               "replayed_records": recovered.replayed_wal_records,
               "live_edges": recovered.stats()["live_edges"]}
    recovered.close()
    return summary


def promote_after_crash(directory: str, *, owner: str = "promoter",
                        lease_ttl_s: float = 0.5, wait_s: float = 30.0,
                        extra_chunks: int = 4, chunk: int = 64,
                        nv: int = 256, seed: int = 0,
                        device=gs.DEFAULT_DEVICE) -> dict:
    """Process-level failover: take over a SIGKILLed ``--ha`` writer's
    store.  Waits out the dead writer's lease TTL, promotes a fresh
    :class:`Replica` (epoch bump + fence + tail drain), appends
    ``extra_chunks`` more chunks as the epoch-``E+1`` leader, and
    proves a resurrected writer at the dead epoch is refused with
    nothing written.  Raises on timeout or a split-brain breach; the
    store is left with a *mixed-epoch* WAL for ``--verify-recovery``."""
    from repro_torch.api import GraphClient
    from repro_torch.ckpt import oplog
    from repro_torch.ckpt.durable import wal_dir
    from repro_torch.core.replicas import Replica
    from repro_torch.fault import errors as fault_errors
    from repro_torch.ha.lease import FileLease
    from repro_torch.launch.stream import typed_op_stream

    lease = FileLease(directory, owner=owner, ttl_s=lease_ttl_s)
    info = lease.peek()
    old_epoch = info.epoch if info is not None \
        else oplog.newest_epoch(wal_dir(directory))
    rep = Replica(directory, 0, query_buckets=(8,), poll_interval=0.05,
                  device=device)
    leader = None
    deadline = time.monotonic() + wait_s
    try:
        while leader is None:
            try:
                # no snapshots: --verify-recovery's scratch oracle
                # replays the full mixed-epoch WAL from gen 0
                leader = rep.promote(lease, sync_every=1,
                                     segment_bytes=16 << 10,
                                     snapshot_every=0)
            except fault_errors.Unavailable:
                if time.monotonic() >= deadline:
                    raise AssertionError(
                        f"dead writer's lease never went stale within "
                        f"{wait_s}s (ttl={lease_ttl_s}s)")
                time.sleep(lease_ttl_s / 4)
        gen_at_takeover = leader.gen
        client = GraphClient(leader)
        for i in range(extra_chunks):
            client.submit_many(typed_op_stream(
                nv, chunk, step=(1 << 19) + i, add_frac=0.7, seed=seed))
        # split-brain probe: the dead writer's epoch must be refused
        # with nothing written
        wdir = wal_dir(directory)
        before = sorted((f, os.path.getsize(os.path.join(wdir, f)))
                        for f in os.listdir(wdir))
        try:
            zombie = oplog.OpLogWriter(wdir, start_gen=leader.gen,
                                       epoch=old_epoch)
            zombie.close()
            raise AssertionError(
                "resurrected old-epoch writer was NOT fenced")
        except fault_errors.Fenced:
            pass
        after = sorted((f, os.path.getsize(os.path.join(wdir, f)))
                       for f in os.listdir(wdir))
        if after != before:
            raise AssertionError(
                "the fenced resurrect probe left bytes in the WAL dir")
        return {"gen_at_takeover": gen_at_takeover, "gen": leader.gen,
                "old_epoch": old_epoch, "new_epoch": leader.epoch,
                "extra_chunks": extra_chunks}
    finally:
        if leader is not None:
            leader.close()
        rep.stop()


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", required=True, help="durable store root")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--nv", type=int, default=1024)
    ap.add_argument("--readers", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--writer-child", action="store_true",
                    help="run the crash-smoke victim writer")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="writer-child: async snapshot period in gens")
    ap.add_argument("--ha", action="store_true",
                    help="writer-child: hold a write lease (SIGKILL "
                         "leaves it stale for --promote-after-crash)")
    ap.add_argument("--lease-ttl", type=float, default=0.5,
                    help="lease TTL in seconds for --ha / promotion")
    ap.add_argument("--promote-after-crash", action="store_true",
                    help="take over a SIGKILLed --ha writer's store: "
                         "promote a replica, append as the new epoch, "
                         "probe the fence")
    ap.add_argument("--verify-recovery", action="store_true",
                    help="recover the store and check both recovery "
                         "paths agree bit-for-bit")
    ap.add_argument("--replica-child", action="store_true",
                    help="run one out-of-process replica (supervised "
                         "mode spawns these)")
    ap.add_argument("--id", type=int, default=0,
                    help="replica-child: replica slot id")
    ap.add_argument("--until-gen", type=int, default=0,
                    help="replica-child: exit 0 once this generation "
                         "is tailed")
    ap.add_argument("--duration", type=float, default=120.0,
                    help="replica-child: safety timeout in seconds")
    ap.add_argument("--device", default=gs.DEFAULT_DEVICE,
                    help="where every role's state lives (cuda or cpu)")
    ap.add_argument("--supervised", action="store_true",
                    help="multi-process serving: parent writer + "
                         "restart-supervised replica children")
    ap.add_argument("--kill-child-after", type=float, default=None,
                    help="supervised: SIGKILL replica child 0 after "
                         "this many seconds (restart injection)")
    args = ap.parse_args()
    if args.replica_child:
        sys.exit(replica_child(args.dir, replica_id=args.id,
                               until_gen=args.until_gen,
                               duration_s=args.duration,
                               device=args.device))
    if args.supervised:
        rep = supervised_stream(args.dir, replicas=args.replicas,
                                steps=args.steps, chunk=args.chunk,
                                nv=args.nv, seed=args.seed,
                                kill_child_after=args.kill_child_after,
                                device=args.device)
        print("supervised OK: " + " | ".join(f"{k}={v}"
                                             for k, v in rep.items()))
        return
    if args.writer_child:
        writer_child(args.dir, nv=args.nv, steps=args.steps,
                     chunk=args.chunk, seed=args.seed,
                     snapshot_every=args.snapshot_every, ha=args.ha,
                     lease_ttl_s=args.lease_ttl, device=args.device)
        return
    if args.promote_after_crash:
        summary = promote_after_crash(args.dir, chunk=args.chunk,
                                      nv=args.nv, seed=args.seed,
                                      lease_ttl_s=args.lease_ttl,
                                      device=args.device)
        print("promote OK: " + " | ".join(f"{k}={v}"
                                          for k, v in summary.items()))
        return
    if args.verify_recovery:
        summary = verify_recovery(args.dir, device=args.device)
        print("recovery OK: " + " | ".join(f"{k}={v}"
                                           for k, v in summary.items()))
        return
    rep = run_replicated_stream(args.dir, replicas=args.replicas,
                                n_ops=args.steps * args.chunk,
                                chunk=args.chunk, nv=args.nv,
                                readers=args.readers, seed=args.seed,
                                device=args.device)
    print(rep.pretty())


if __name__ == "__main__":
    main()
