"""End-to-end driver on the PyTorch/CUDA port: a fault-tolerant
dynamic-SCC serving loop, as examples/dynamic_scc_serving.py runs it on the
JAX package.

This is the paper's system run the way it would run in production, behind
the port's typed public API (:class:`repro_torch.api.GraphClient`):
  * a sustained stream of typed update ops applied through an updater
    client session (the service's pipelined in-flight window underneath),
    overlapped with **concurrent reader sessions** — one ``GraphClient``
    per reader thread over a shared dispatcher-fed
    :class:`repro_torch.core.broker.QueryBroker` — issuing coalesced typed
    snapshot queries (the paper's mixed workload, Fig 4/5), all cut into
    bucketed batch shapes,
  * **grow-and-replay**: the edge table starts deliberately small; when
    probe-bound overflow drops an insert, the service rehashes into a
    larger capacity and replays it -- no edge is ever lost,
  * periodic atomic checkpoints of the WHOLE GraphState (the engine's
    "database") with crash-safe restore -- kill it mid-run and restart to
    see it resume at the checkpointed chunk cursor.  The checkpoint
    records the (possibly grown) edge capacity so restore rebuilds the
    right template shapes, and the generation counter so restore can
    assert **gen continuity**: the restored client resumes exactly at the
    committed generation the checkpoint saw,
  * throughput + straggler accounting per chunk; GC (edge-table
    compaction) happens inside the service when tombstones pile up.

    PYTHONPATH=src python examples/dynamic_scc_serving_torch.py \
        [--steps N] [--readers N] [--device cpu] [--ckpt-dir D] [--reset]
    PYTHONPATH=src python examples/dynamic_scc_serving_torch.py --smoke \
        --device cpu  # CI

The checkpoints go to ``--ckpt-dir`` (default: ``smscc_serving_ckpt_torch``
under the temporary directory; with ``--smoke`` a fresh temporary
directory unless ``--ckpt-dir`` names one).  Runs on the card unless
``--device`` says otherwise.
"""
import argparse
import dataclasses
import os
import tempfile
import threading
import time

import numpy as np

from repro_torch.api import AddEdge, GraphClient, Reachable, SameSCC
from repro_torch.ckpt import checkpoint
from repro_torch.core import graph_state as gs
from repro_torch.core.broker import QueryBroker
from repro_torch.core.service import SCCService
from repro_torch.launch.stream import typed_op_stream

NV = 4096
BATCH = 256
QUERIES = 1024
CKPT_DIR = os.path.join(tempfile.gettempdir(), "smscc_serving_ckpt_torch")
CKPT_EVERY = 10


def preload_graph(client: GraphClient, nv: int, preload: int):
    """Preload a random digraph THROUGH the typed client so the
    deliberately undersized table grows (and replays) instead of silently
    dropping edges the way a raw bulk insert would."""
    rng = np.random.default_rng(0)
    client.submit_many([AddEdge(int(a), int(b)) for a, b in
                        zip(rng.integers(0, nv, preload),
                            rng.integers(0, nv, preload))])
    st = client.stats()
    print(f"[preload] {st['live_edges']} edges | capacity "
          f"{st['edge_capacity']} (grows={st['grows']}, "
          f"replayed={st['replayed_ops']})")


def reader_loop(client: GraphClient, stop: threading.Event, nv: int,
                n_queries: int, seed: int, out: dict):
    """Free-running reader session: coalesced typed SameSCC (+ occasional
    Reachable) batches; checks its observed generations never go
    backwards.  Any failure is stashed in ``out`` and re-raised by the
    main thread (a daemon thread's own traceback cannot fail the CI
    smoke)."""
    rng = np.random.default_rng(seed)
    last_gen = -1
    try:
        while not stop.is_set():
            qu = rng.integers(0, nv, n_queries)
            qv = rng.integers(0, nv, n_queries)
            res = client.submit_many(
                [SameSCC(int(a), int(b)) for a, b in zip(qu, qv)])
            assert res[0].gen >= last_gen, "reader saw generation regress"
            last_gen = res[0].gen
            out["queries"] += n_queries
            if rng.random() < 0.25:
                res = client.submit_many(
                    [Reachable(int(a), int(b)) for a, b in
                     zip(qu[:64], qv[:64])])
                last_gen = max(last_gen, res[0].gen)
                out["queries"] += 64
    except BaseException as e:
        out["error"] = e
        stop.set()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--readers", type=int, default=2,
                    help="concurrent reader threads (0 = updates only)")
    ap.add_argument("--reset", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CPU-friendly run against a throwaway "
                         "checkpoint dir (the CI docs gate)")
    ap.add_argument("--device", default=gs.DEFAULT_DEVICE)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (kept across runs: resume)")
    args = ap.parse_args()
    if args.smoke:
        nv, batch, queries, preload = 512, 128, 256, 400
        steps = min(args.steps, 6)
        ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(
            prefix="smscc_serving_smoke_")
        ckpt_every = 3
    else:
        nv, batch, queries, preload = NV, BATCH, QUERIES, 4000
        steps = args.steps
        ckpt_dir = args.ckpt_dir or CKPT_DIR
        ckpt_every = CKPT_EVERY
    if args.reset and os.path.exists(ckpt_dir):
        for f in os.listdir(ckpt_dir):
            os.remove(os.path.join(ckpt_dir, f))

    cfg = gs.GraphConfig(n_vertices=nv, edge_capacity=max(512, nv),
                         max_probes=128, max_outer=64, max_inner=128)
    svc = None
    cursor = 0

    # crash recovery: the meta leaves restore first (extra npz keys are
    # ignored), telling us what edge capacity the state template needs --
    # the table may have grown beyond the boot config before the crash --
    # and what committed generation the checkpoint captured.
    try:
        meta, _ = checkpoint.restore(
            ckpt_dir, {"cursor": np.int64(0),
                       "edge_capacity": np.int64(cfg.edge_capacity),
                       "gen": np.int64(0)})
    except KeyError:  # checkpoint from an older format: start fresh, and
        # clear the stale files so a future torn-LATEST fallback cannot
        # resurrect them over newer new-format progress
        print("[recovery] unreadable (old-format) checkpoint removed")
        for f in os.listdir(ckpt_dir):
            os.remove(os.path.join(ckpt_dir, f))
        meta = None
    if meta is not None:
        cap = int(meta["edge_capacity"])
        ck_cfg = dataclasses.replace(cfg, edge_capacity=cap)
        tpl = {"state": gs.empty(ck_cfg, args.device), "cursor": np.int64(0),
               "edge_capacity": np.int64(cap), "gen": np.int64(0)}
        restored, _ = checkpoint.restore(ckpt_dir, tpl)
        svc = SCCService(ck_cfg, buckets=(64, batch),
                         state=restored["state"])
        cursor = int(restored["cursor"])
        # gen continuity: the restored service (and therefore every new
        # client session, whose read-your-writes token seeds from it)
        # resumes exactly at the generation the checkpoint committed.
        saved_gen = int(meta["gen"])
        assert svc.gen == saved_gen == int(restored["state"].gen), (
            f"generation discontinuity across restore: service at "
            f"{svc.gen}, checkpoint recorded {saved_gen}")
        print(f"[recovery] resumed at chunk {cursor} (capacity {cap}, "
              f"gen {saved_gen})")
    if svc is None:
        svc = SCCService(cfg, buckets=(64, batch),
                         state=gs.all_singletons(cfg, args.device))

    # one shared broker; per-session typed clients on top
    broker = QueryBroker(svc, buckets=(64, queries)).start()
    updater = GraphClient(svc, broker=broker)
    if cursor == 0 and int(gs.live_edge_count(svc.state)) == 0:
        preload_graph(updater, nv, preload)  # no usable checkpoint
    assert updater.token == svc.gen  # session token tracks the commit line

    # the reader path: per-thread client sessions over the shared broker
    stop = threading.Event()
    reader_stats = [{"queries": 0} for _ in range(args.readers)]
    readers = [threading.Thread(
        target=reader_loop,
        args=(GraphClient(svc, broker=broker), stop, nv, queries, 100 + i,
              reader_stats[i]), daemon=True)
        for i in range(args.readers)]
    for t in readers:
        t.start()

    times = []
    stragglers = 0
    t_start = time.perf_counter()
    try:
        for step in range(cursor, steps):
            ops = typed_op_stream(nv, batch, step=step, add_frac=0.7)
            t0 = time.perf_counter()
            updater.submit_many(ops)
            dt = time.perf_counter() - t0
            times.append(dt)
            med = sorted(times[-50:])[len(times[-50:]) // 2]
            if len(times) > 5 and dt > 3 * med:
                stragglers += 1
                print(f"[straggler] chunk {step}: {dt*1e3:.0f}ms vs median "
                      f"{med*1e3:.0f}ms")
            if (step + 1) % ckpt_every == 0:
                st = updater.stats()
                checkpoint.save(
                    ckpt_dir, step + 1,
                    {"state": svc.state, "cursor": np.int64(step + 1),
                     "edge_capacity": np.int64(svc.cfg.edge_capacity),
                     "gen": np.int64(svc.gen)})
                print(f"[ckpt] chunk {step+1} | {batch/med:.0f} updates/s"
                      f" | {st['n_ccs']} SCCs | gen={st['gen']}"
                      f" | capacity={st['edge_capacity']}"
                      f" (grows={st['grows']}, "
                      f"replayed={st['replayed_ops']},"
                      f" compactions={st['compactions']})")
    finally:
        stop.set()
        for t in readers:
            t.join()
        broker.stop()
    for r in reader_stats:
        if "error" in r:
            raise r["error"]

    total = time.perf_counter() - t_start
    done = steps - cursor
    n_queries = sum(r["queries"] for r in reader_stats)
    st = updater.stats()
    print(f"\nserved {done} chunks in {total:.1f}s | "
          f"{done*batch/total:.0f} updates/s | "
          f"{n_queries/total:.0f} queries/s ({args.readers} readers, "
          f"{st['coalescing']:.0f} coalesced/flush) | "
          f"stragglers={stragglers} | "
          f"scan dispatches={st['scan_dispatches']} | "
          f"pipelined={st['pipelined_chunks']} "
          f"fallback={st['fallback_chunks']} "
          f"gen_waits={st['gen_waits']} | on {st['device']}")


if __name__ == "__main__":
    main()
