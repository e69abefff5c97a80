#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) once on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one card, nvcc and
PyTorch built for CUDA.  It needs no network and imports nothing of JAX.
Phases, each printing one line:

1. card and build: the card's name and power limit (nvidia-smi), then the
   three kernels built from csrc/ with nvcc for sm_90a, in parallel (build
   seconds, ptxas register and spill lines);
2. kernels: each kernel held bit-exact against its plain PyTorch version on
   the card at the main path's shapes, with CUDA-event times: the kernel
   and one library call as device time per call (calls captured in a CUDA
   graph and replayed), the kernel's wrapper called back to back
   (``host_ms``: device time plus the host's launch cost), the plain
   version, and the least time the card could take for the same work
   (bytes over 3.35 TB/s or operations over the int8 peak of 1,979 TOP/s,
   H100 SXM data sheet);
3. main path at the update_1m shape: 2^20 vertices, a 2^23-slot edge
   table preloaded with 2^21 random edges (out-degree 2, so a giant SCC
   makes repairs real) and one full recompute, then super-chunks of the
   paper's mix (add_frac 0.7, vertex ops on) through a GraphClient with
   SameSCC (1024) and Reachable (32) query batches between them.  The
   launch counts are set to 0 just before and read just after; the
   maintained labels must equal a fresh static recompute of the final
   graph;
4. dense tier: the same path, smaller, with dense_capacity=512, read the
   same way (reach_blockmm must launch);
5. card vs CPU: one seeded stream at 2^14 vertices and a 2^16-slot table
   through the port on the card and on the CPU (plain versions): per-op
   results, labels and edge sets must be identical;
6. the kernels line (JSON), the card line, and the device line last.

Any failed check exits non-zero.  Without a CUDA card it exits 1 before
printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, data sheet
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak
SEED = 0

KERNELS = {
    "frontier_min": dict(
        source="src/repro_torch/csrc/frontier_min.cu",
        replaces="src/repro/kernels/frontier_expand/kernel.py:54"),
    "hash_probe": dict(
        source="src/repro_torch/csrc/hash_probe.cu",
        replaces="src/repro/kernels/hash_probe/kernel.py:73"),
    "bool_matmul": dict(
        source="src/repro_torch/csrc/bool_matmul.cu",
        replaces="src/repro/kernels/reach_blockmm/kernel.py:41"),
}


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


# ------------------------------------------------------------- timing ---

def cuda_ms(torch, fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps: int) -> float:
    """Mean device ms per call: ``reps`` calls captured in one CUDA graph
    and replayed, so the host's per-call launch cost (Python, wrapper
    checks, ctypes) drops out of short kernels' times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def checked_row(row: dict) -> dict:
    """A measured time below the least time the card could take means the
    timing missed the kernel (e.g. an empty graph), not a fast kernel."""
    check(row["ms"] >= row["bound_ms"],
          f"{row['shape']}: {row['ms']} ms is below its bound")
    return row


def bound_ms(n_bytes: float, n_ops: float = 0.0):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, got, want) -> float:
    return float((got.long() - want.long()).abs().max()) if got.numel() else 0.0


# ------------------------------------------------------------ phase 2 ---

def kernel_checks(torch, dev) -> dict:
    """Each kernel against its plain version at main-path shapes; returns
    name -> measurement dict (at the main path's shape of that kernel)."""
    from repro_torch.core import edge_table as et
    from repro_torch.kernels.frontier_expand import ops as fops
    from repro_torch.kernels.frontier_expand import ref as fref
    from repro_torch.kernels.hash_probe import ops as hops
    from repro_torch.kernels.hash_probe import ref as href
    from repro_torch.kernels.reach_blockmm import ops as bops
    from repro_torch.kernels.reach_blockmm import ref as bref

    g = torch.Generator(device=dev).manual_seed(SEED)
    out = {}

    # frontier_min: NV 2^20, E 2^23 (the table), F 1 and F 32 (queries)
    nv, e = 2 ** 20, 2 ** 23
    dst = torch.randint(0, nv, (e,), generator=g, device=dev,
                        dtype=torch.int32)
    rows = []
    for f in (1, 32):
        msg = torch.randint(0, 2 ** 32, (f, e), generator=g, device=dev)
        msg[torch.rand((f, e), generator=g, device=dev) < 0.5] = \
            fref.SENTINEL
        got = fops.frontier_min(dst, msg, nv)
        want = fref.frontier_min(dst, msg, nv)
        err = max_abs_err(torch, got, want)
        check(torch.equal(got, want), f"frontier_min F={f} disagrees")
        idx = dst.long().expand(f, e)
        base = torch.full((f, nv), fref.SENTINEL, dtype=torch.int64,
                          device=dev)
        reps = 10 if f == 1 else 3
        # the bound is that of the uint32 function the TPU kernel computes
        # (4 B per dst, per message and per output word); the port's int64
        # carrier moves twice the message and output bytes, a cost the
        # kernel pays and the bound does not grant
        b_ms, b_by = bound_ms(4 * e + 4 * f * e + 4 * f * nv)
        row = dict(shape=f"F={f} E={e} NV={nv}", max_abs_err=err,
                   ms=graph_ms(torch, lambda: fops.frontier_min(dst, msg, nv),
                               reps),
                   host_ms=cuda_ms(
                       torch, lambda: fops.frontier_min(dst, msg, nv), reps),
                   plain_ms=cuda_ms(
                       torch, lambda: fref.frontier_min(dst, msg, nv), reps),
                   library_ms=graph_ms(torch, lambda: torch.scatter_reduce(
                       base, 1, idx, msg, reduce="amin"), reps),
                   bound_ms=b_ms, bound_by=b_by)
        rows.append(checked_row(row))
        del msg, got, want, idx, base
    emit("kernel", name="frontier_min", tolerance="exact", rows=rows)
    out["frontier_min"] = rows[0]

    # hash_probe: C 2^23 at 25% load with TOMB chains, B 8192, 64 probes
    cap, n_keys, b, max_probes = 2 ** 23, 2 ** 21, 8192, 64
    ku = torch.randint(0, 2 ** 20, (n_keys,), generator=g, device=dev,
                       dtype=torch.int32)
    kv = torch.randint(0, 2 ** 20, (n_keys,), generator=g, device=dev,
                       dtype=torch.int32)
    table, _, _ = et.insert(et.empty(cap, dev), ku, kv, max_probes)
    gone = n_keys // 4
    table, _ = et.remove(table, ku[:gone], kv[:gone], max_probes)
    pick = torch.randint(0, n_keys, (b,), generator=g, device=dev)
    qu = torch.where(torch.arange(b, device=dev) % 2 == 0, ku[pick],
                     torch.randint(0, 2 ** 20, (b,), generator=g,
                                   device=dev, dtype=torch.int32))
    qv = kv[pick]
    base = et._hash(qu, qv, cap)
    args = (table.src, table.dst, table.state, base, qu, qv)
    got = hops.probe(*args, max_probes=max_probes)
    want = href.probe(*args, max_probes=max_probes)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "hash_probe disagrees")
    visited = probe_visits(torch, table, base, qu, qv, max_probes)
    b_ms, b_by = bound_ms(12 * b + 9 * visited + 5 * b)
    row = dict(shape=f"C={cap} B={b} max_probes={max_probes} "
                     f"live={n_keys - gone} slots_visited={visited}",
               max_abs_err=max(max_abs_err(torch, got[0], want[0]),
                               max_abs_err(torch, got[1], want[1])),
               ms=graph_ms(torch, lambda: hops.probe(
                   *args, max_probes=max_probes), 20),
               host_ms=cuda_ms(torch, lambda: hops.probe(
                   *args, max_probes=max_probes), 20),
               plain_ms=cuda_ms(torch, lambda: href.probe(
                   *args, max_probes=max_probes), 5),
               library_ms=None, bound_ms=b_ms, bound_by=b_by)
    emit("kernel", name="hash_probe", tolerance="exact",
         rows=[checked_row(row)])
    out["hash_probe"] = row
    del table, args, got, want

    # bool_matmul: R in {128, 512, 1024}; 512 is the dense tier's R
    rows = []
    for r in (128, 512, 1024):
        a = torch.rand((r, r), generator=g, device=dev) < 4.0 / r
        bm = torch.rand((r, r), generator=g, device=dev) < 4.0 / r
        got = bops.bool_matmul(a, bm)
        want = bref.bool_matmul(a, bm)
        check(torch.equal(got, want), f"bool_matmul R={r} disagrees")
        a16, b16 = a.half(), bm.half()
        b_ms, b_by = bound_ms(3 * r * r, 2 * r ** 3)
        rows.append(checked_row(dict(
            shape=f"R={r}", max_abs_err=max_abs_err(torch, got, want),
            ms=graph_ms(torch, lambda: bops.bool_matmul(a, bm), 20),
            host_ms=cuda_ms(torch, lambda: bops.bool_matmul(a, bm), 20),
            plain_ms=cuda_ms(torch, lambda: bref.bool_matmul(a, bm), 20),
            library_ms=graph_ms(torch, lambda: torch.matmul(a16, b16) > 0,
                                20),
            bound_ms=b_ms, bound_by=b_by)))
    emit("kernel", name="bool_matmul", tolerance="exact", rows=rows)
    out["bool_matmul"] = rows[1]
    return out


def probe_visits(torch, table, base, u, v, max_probes) -> int:
    """Slots the walk of every lane reads on these inputs (the data-
    dependent byte count of the probe bound)."""
    cap = table.src.shape[0]
    done = torch.zeros(u.shape[0], dtype=torch.bool, device=u.device)
    visits = torch.zeros((), dtype=torch.int64, device=u.device)
    for i in range(max_probes):
        pos = ((base + i) & (cap - 1)).long()
        st = table.state[pos]
        visits += (~done).sum()
        hit = (st == 1) & (table.src[pos] == u) & (table.dst[pos] == v)
        done = done | hit | (st == 0)
    return int(visits)


# -------------------------------------------------------- phases 3 - 5 ---

def serve_path(torch, dev, *, nv, cap, bucket, chunk, n_chunks,
               preload_deg, dense_capacity=0, budget_s=None,
               n_same=1024, record=None):
    """Boot (optional out-degree preload + recompute), then ``n_chunks``
    typed update chunks with SameSCC (``n_same``) and Reachable (32) query
    batches between them, through the port's own stream driver
    (``launch.stream.run_stream``).  Returns a report dict and the
    service; ``record`` collects every Result's (value, gen) for the
    card-vs-CPU comparison."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import smscc
    from repro_torch.core import dynamic
    from repro_torch.core import graph_state as gs
    from repro_torch.core.service import SCCService
    from repro_torch.launch import stream

    cfg = smscc.config(n_vertices=nv, edge_capacity=cap,
                       dense_capacity=dense_capacity)
    rng = np.random.default_rng(SEED)
    rep = {"n_vertices": nv, "edge_capacity": cap, "bucket": bucket,
           "dense_capacity": dense_capacity}
    t0 = time.perf_counter()
    if preload_deg:
        src = np.repeat(np.arange(nv, dtype=np.int32), preload_deg)
        dst = rng.integers(0, nv, src.shape[0]).astype(np.int32)
        state = gs.from_arrays(cfg, src, dst, device=dev)
        state = dynamic.recompute(state, cfg)
        rep["preload_edges"] = int(src.shape[0])
    else:
        state = gs.all_singletons(cfg, dev)
    sync(torch, dev)
    rep["boot_s"] = time.perf_counter() - t0

    svc = SCCService(cfg, buckets=(bucket,), state=state,
                     scan_lengths=smscc.SCAN_LENGTHS, proactive_grow=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    run = stream.run_stream(svc, n_chunks * chunk, add_frac=0.7,
                            query_frac=1.0, chunk=chunk, n_queries=n_same,
                            seed=SEED, budget_s=budget_s, record=record)
    rep["launches"] = kernels.launch_counts()
    steps = sum(run[f"repair_{t}_steps"] for t in
                ("dense", "compact", "full", "skipped"))
    rep.update(
        chunks=run["chunks"], chunks_asked=n_chunks, ops=run["ops"],
        queries=run["queries"], steps=steps, update_s=run["update_s"],
        query_s=run["query_s"], ops_per_s=run["ops_per_s"],
        queries_per_s=run["queries_per_s"],
        host_syncs=run["update_syncs"] + run["query_syncs"],
        update_host_syncs_per_step=run["update_syncs"] / max(steps, 1),
        update_launches_per_step={k: n / max(steps, 1) for k, n in
                                  run["update_launches"].items()},
        query_syncs=run["query_syncs"],
        query_launches=run["query_launches"],
        repair_steps={t: run[f"repair_{t}_steps"] for t in
                      ("dense", "compact", "full", "skipped")},
        region_v_max=run["repair_region_v_max"],
        region_e_max=run["repair_region_e_max"],
        grows=run["grows"], proactive_grows=run["proactive_grows"],
        compactions=run["compactions"], gen=run["gen"],
        live_edges=run["live_edges"], n_ccs=run["n_ccs"])
    if dev.type == "cuda":
        rep["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    # the maintained labels must equal a static recompute of the final
    # graph (the repo's own oracle: dynamic == static)
    t0 = time.perf_counter()
    final = svc.state
    fresh = dynamic.recompute(final, svc.cfg)
    check(torch.equal(fresh.ccid, final.ccid),
          "maintained labels differ from a static recompute")
    check(int(final.ccid.max()) <= nv and int(final.ccid.min()) >= 0,
          "labels out of range")
    rep["verify_s"] = time.perf_counter() - t0
    return rep, svc


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    t_all = time.perf_counter()
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit("card", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    _build.build()
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={k: v[1] for k, v in _build.build_log.items()})

    t0 = time.perf_counter()
    kern = kernel_checks(torch, dev)
    emit("kernels_checked", seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()

    main_rep, _ = serve_path(torch, dev, nv=2 ** 20, cap=2 ** 23,
                             bucket=8192, chunk=4 * 8192, n_chunks=8,
                             preload_deg=2, budget_s=300.0)
    emit("main_path", **main_rep)
    if main_rep["chunks"] < main_rep["chunks_asked"]:
        emit("main_path_cut", chunks=main_rep["chunks"],
             asked=main_rep["chunks_asked"], reason="time budget")
    for k in ("frontier_min", "hash_probe"):
        check(main_rep["launches"][k] > 0, f"{k} never launched")
    torch.cuda.empty_cache()

    dense_rep, _ = serve_path(torch, dev, nv=2 ** 14, cap=2 ** 16,
                              bucket=256, chunk=1024, n_chunks=8,
                              preload_deg=0, dense_capacity=512,
                              n_same=256)
    emit("dense_tier", **dense_rep)
    check(dense_rep["launches"]["bool_matmul"] > 0,
          "bool_matmul never launched")
    check(dense_rep["repair_steps"]["dense"] > 0, "dense tier never ran")

    t0 = time.perf_counter()
    runs = {}
    for d in (dev, torch.device("cpu")):
        rec = []
        rep, svc = serve_path(torch, d, nv=2 ** 14, cap=2 ** 16, bucket=1024,
                              chunk=4096, n_chunks=4, preload_deg=2,
                              n_same=256, record=rec)
        runs[d.type] = (rec, svc.state.ccid.cpu().tolist(), svc.edge_set(),
                        rep["repair_steps"])
    same = {k: runs["cuda"][i] == runs["cpu"][i] for i, k in
            enumerate(("results", "labels", "edges", "repair_steps"))}
    emit("card_vs_cpu", seconds=time.perf_counter() - t0,
         n_results=len(runs["cuda"][0]), **same)
    check(all(same.values()), f"card and CPU runs differ: {same}")

    launches = {"frontier_min": main_rep["launches"]["frontier_min"],
                "hash_probe": main_rep["launches"]["hash_probe"],
                "bool_matmul": dense_rep["launches"]["bool_matmul"]}
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name]["source"],
             replaces=KERNELS[name]["replaces"], launches=launches[name],
             max_abs_err=kern[name]["max_abs_err"], ms=kern[name]["ms"],
             host_ms=kern[name]["host_ms"], plain_ms=kern[name]["plain_ms"],
             bound_ms=kern[name]["bound_ms"],
             bound_by=kern[name]["bound_by"],
             library_ms=kern[name]["library_ms"],
             shape=kern[name]["shape"])
        for name in KERNELS]}), flush=True)
    emit("total", seconds=time.perf_counter() - t_all)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        sys.exit(2)
