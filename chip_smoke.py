#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) once on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one card, nvcc and
PyTorch built for CUDA.  It needs no network and imports nothing of JAX.
Phases, each printing one line or more:

1. card and build: the card's name and power limit (nvidia-smi), then the
   five kernels built from csrc/ with nvcc for sm_90a, in parallel (build
   seconds, ptxas register and spill lines), and the tensor-core
   instructions in the built code (``cuobjdump -sass``: HGMMA in
   flash_attention, IMMA or IGMMA in bool_matmul; none fails the run);
2. kernels: each kernel held against its plain PyTorch version on the card
   at the main paths' shapes (exact for the SMSCC kernels, bool_matmul
   also at density 1.0; 3e-2 for bf16 and 2e-5 for f32 attention, and the
   bf16 kernel against the f32 answer at the main shapes and at four
   band-sensitive shapes; 1e-5 for the embedding bag), with CUDA-event
   times: the kernel and one library call as device time per call (calls
   captured in a CUDA graph and replayed), the kernel's wrapper called back
   to back (``host_ms``: device time plus the host's launch cost), the
   plain version, and the least time the card could take for the same work
   (bytes over 3.35 TB/s, or operations over the peak of their type: int8
   1,979 TOP/s, bf16 989 TFLOP/s, f32 67 TFLOP/s; H100 SXM data sheet);
   frontier_min also at the main path's own traffic, on update_1m's
   preloaded graph: one round of each kind (boolean, label, FW/BW pair,
   packed Reachable batch), the fused kernel and the fused round body
   beside the unfused body (int64 messages built in torch, then the direct
   kernel) it replaced, each held to the other exactly;
   the edge table's write path at update_1m's table (2^23 slots, 2^21
   edges, a quarter removed): the boot insert, an 8192-lane insert with
   duplicates and an enable mask, an 8192-lane remove, compact, rehash to
   2^24 and an insert into a table at ~95% load with failed lanes, each
   ``et.*`` call (the kernel) held exactly to the parent's path (the plain
   rounds) on the card, with its rounds, device, kernel, host and plain
   times and its byte bound;
3. SMSCC main path at the update_1m shape: 2^20 vertices, a 2^23-slot
   edge table preloaded with 2^21 random edges (out-degree 2, so a giant
   SCC makes repairs real) and one full recompute, then super-chunks of
   the paper's mix (add_frac 0.7, vertex ops on) through a GraphClient
   with SameSCC (1024) and Reachable (32) query batches between them.  The
   launch counts are set to 0 just before and read just after; the
   maintained labels must equal a fresh static recompute of the final
   graph;
4. dense tier: the same path, smaller, with dense_capacity=512, read the
   same way (reach_blockmm must launch);
5. card vs CPU: one seeded stream at 2^14 vertices and a 2^16-slot table
   through the port on the card and on the CPU (plain versions): per-op
   results, labels and edge sets must be identical;
6. embedding-bag path: MIND-shaped requests (2^21 x 64 f32 table, 512 bags
   of 50 ids, ~20% padding) in sum, weighted and mean modes through the
   wrapper, counted the same way;
7. LM main path: ``launch.serve.serve_lm`` with Qwen3-14B at full width and
   depth (40 layers, bf16, random weights from a seeded generator on the
   card, flash attention): 4 requests of 4096 prompt tokens, then 32
   greedy decode steps; flash must launch once per layer of the prefill,
   on the [B,S,H,D] buffers as they lie (no layout copy);
   one more decode step, replayed from a CUDA graph, gives the device's
   time per step apart from the host's;
8. LM card vs CPU: the qwen3 and danube smoke configs in f32 (TF32 off),
   the same weights on both devices through ``carry``, prefill then decode
   teacher-forced with the CPU's greedy tokens: logits within 2e-4;
9. durable path (run after phase 5): update_1m's booted graph takes the 8
   chunks through a plain SCCService, then through a DurableService
   writer (fsync per record, a background snapshot every 4 generations)
   while 2 WAL-tailing replicas serve 2 read-your-writes sessions; the
   replicas must reach the writer's state leaf for leaf, and after a
   crash (no close) recovery and a scratch replay of the whole WAL must
   equal the writer's last commit; a store written on the card at 2^14
   vertices must open bit-identically on the CPU; run_concurrent_stream
   with 2 readers must end on the plain run's state; and
   ``serve_smscc(replicas=2)`` runs at the reference's defaults.  The
   stores live in a temporary directory, removed afterwards;
10. tenant path (run after phase 9, ``tenant_path``): a TenantEngine
   holding 256 tenants of 4096 vertices and 2^14 slots (out-degree-2
   preload: the full tier), 64 at 2^13 slots (no preload: the compact
   tier) and one booted at 1024 slots (it overflows, replays solo and
   migrates) takes 8 waves of one 1024-op chunk per tenant; every tenant
   must equal its own single-tenant SCCService fed the same chunks on
   the card (ops/s of both), labels a static recompute for a sample;
   class A's host syncs per wave at T = 256 within 2x of T = 8; 8 tenants
   on the card equal the CPU; ``serve_tenants`` plain and with a durable
   root (its stores open equal on the CPU); one chaos soak seed.  The
   tenant-row forms of frontier_min and hash_probe are held to their
   plain versions at class A's shape and timed;
11. the kernels line (JSON; frontier_min and hash_probe also carry their
   tenant-row form under ``lanes``), the card line, and the device line
   last.

Any failed check exits non-zero.  Without a CUDA card it exits 1 before
printing any result.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, data sheet
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
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
    "flash_attention": dict(
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:81"),
    "embedding_bag": dict(
        source="src/repro_torch/csrc/embedding_bag.cu",
        replaces="src/repro/kernels/embedding_bag/kernel.py:45"),
}


# what each kernel's built code must hold: tensor-core instructions (SASS)
TENSOR_CORE_OPS = {"flash_attention": ("HGMMA",),
                   "bool_matmul": ("IMMA", "IGMMA")}


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


def bound_ms(n_bytes: float, n_ops: float = 0.0,
             ops_per_s: float = INT8_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
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
    del dst
    torch.cuda.empty_cache()
    rounds = frontier_round_checks(torch, dev, g)
    emit("frontier_rounds", tolerance="exact", rows=rounds)
    # the main path's own form: the fused boolean round at update_1m
    out["frontier_min"] = rounds[0]

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
    # exactness where counts run far above 127 (density 1.0) and at ragged,
    # unaligned shapes (byte staging)
    exact = []
    for m, k, n, density in ((512, 1024, 512, 1.0), (1024, 1024, 1024, 1.0),
                             (65, 33, 130, 0.3), (512, 512, 512, 0.5)):
        a = torch.rand((m, k), generator=g, device=dev) < density
        bm = torch.rand((k, n), generator=g, device=dev) < density
        same = torch.equal(bops.bool_matmul(a, bm), bref.bool_matmul(a, bm))
        exact.append({"shape": f"M={m} K={k} N={n} density={density}",
                      "equal": same})
        check(same, f"bool_matmul M={m} K={k} N={n} density {density} "
                    f"disagrees")
    emit("kernel", name="bool_matmul", tolerance="exact", rows=rows,
         exact_checks=exact)
    out["bool_matmul"] = rows[1]
    return out


def frontier_round_checks(torch, dev, g, nv=2 ** 20, cap=2 ** 23) -> list:
    """One round of each kind the SMSCC path runs, on update_1m's preloaded
    graph (2^20 vertices, 2^23 slots, 2^21 live edges of out-degree 2) at
    the state a few rounds into its fixpoint: a boolean F=1 round (8192
    seeds, one update bucket's worth), a label round (the recompute's
    coloring sweep), the fused FW/BW pair and a packed Reachable batch of
    32 single-source frontiers.  The fused kernel is held to its plain
    version and the fused round body to the unfused one (the port's
    earlier body: int64 messages built in torch over every slot, then the
    direct ``frontier_min``), both exactly.  Times, all device time from replayed
    CUDA graphs except ``host_ms`` and ``plain_ms``: the kernel, a whole
    round body fused (``body_ms``) and unfused (``unfused_body_ms``), and
    the direct kernel alone on the unfused body's messages
    (``unfused_kernel_ms``).  The bound counts src, dst (4 B) and live (1 B)
    per slot, val and out (4 B per vertex and row or packed word)."""
    import numpy as np

    from repro_torch.configs import smscc
    from repro_torch.core import graph_state as gs
    from repro_torch.core import reach
    from repro_torch.kernels.frontier_expand import ops as fops
    from repro_torch.kernels.frontier_expand import ref as fref

    pre, seeds = 3, min(8192, nv // 16)
    rng = np.random.default_rng(SEED)
    src_np = np.repeat(np.arange(nv, dtype=np.int32), 2)
    state = gs.from_arrays(smscc.config(n_vertices=nv, edge_capacity=cap),
                           src_np, rng.integers(0, nv, src_np.shape[0])
                           .astype(np.int32), device=dev)
    src, dst, live = gs.edge_coo(state)
    allowed = state.v_alive
    n_live = int(live.sum())

    def some(n):
        m = torch.zeros(nv, dtype=torch.bool, device=dev)
        m[torch.randint(0, nv, (n,), generator=g, device=dev)] = True
        return m

    vid = torch.arange(nv, dtype=torch.int32, device=dev)
    q = 32
    single = torch.zeros((q, nv), dtype=torch.bool, device=dev)
    single[torch.arange(q, device=dev),
           torch.randint(0, nv, (q,), generator=g, device=dev)] = True
    fw, bw, _ = reach.fused_fw_bw_reach(src, dst, live, some(seeds),
                                        some(seeds), allowed, pre)
    cases = (
        ("boolean F=1", 1, "min", reach.forward_reach(
            src, dst, live, some(seeds), allowed, pre)[0],
         lambda r: reach.reach_round(src, dst, live, allowed, r)),
        ("labels F=1", 1, "min", reach.propagate_min_labels(
            src, dst, live, vid, allowed, pre)[0],
         lambda lab: reach.label_round(src, dst, live, allowed, lab)),
        ("fw/bw pair F=2", 2, "pair", torch.stack([fw, bw]),
         lambda r: reach.fw_bw_round(src, dst, live, allowed, r)),
        (f"packed Reachable Q={q} W=1", 1, "or", fops.pack_bits(
            reach.multi_forward_reach(src, dst, live, single, allowed,
                                      pre)[0]),
         lambda b: reach.multi_reach_round(src, dst, live, allowed, b)))
    rows = []
    for tag, f, mode, st, body in cases:
        if mode == "or":
            val, unfused_st = st, fops.unpack_bits(st, q)
        else:
            val = (reach._reached_val(st) if st.dtype == torch.bool
                   else torch.where(allowed, st, fops.SENT_WORD))
            unfused_st = st
        kern = (lambda v=val, m=mode: fops.frontier_gather(
            src, dst, live, v, nv, mode=m))
        got = kern()
        want = fref.frontier_gather(src, dst, live, val.view(f, -1), nv, mode)
        check(torch.equal(got.view(f, -1), want),
              f"frontier_gather {tag} disagrees with its plain version")
        nxt, _ = body(st)
        old_kind = {"min": "bool" if st.dtype == torch.bool else "labels",
                    "pair": "pair", "or": "multi"}[mode]
        old_nxt, _ = unfused_round(torch, fops, old_kind, src, dst, live,
                                   allowed, unfused_st)
        check(torch.equal(fops.unpack_bits(nxt, q) if mode == "or" else nxt,
                          old_nxt),
              f"fused {tag} round differs from the unfused round")
        msg = unfused_messages(torch, fops, old_kind, src, dst, live,
                               allowed, unfused_st)
        b_ms, b_by = bound_ms(9 * src.shape[0] + 2 * 4 * f * nv)
        reps = 20
        rows.append(checked_row(dict(
            shape=f"{tag}: E={src.shape[0]} live={n_live} NV={nv}, state "
                  f"after {pre} rounds",
            max_abs_err=max_abs_err(torch, got.view(f, -1), want),
            ms=graph_ms(torch, kern, reps), host_ms=cuda_ms(torch, kern, reps),
            plain_ms=cuda_ms(torch, lambda v=val, m=mode: fref.frontier_gather(
                src, dst, live, v.view(f, -1), nv, m), 3),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            body_ms=graph_ms(torch, lambda s_=st, b=body: b(s_), reps),
            unfused_body_ms=graph_ms(
                torch, lambda s_=unfused_st, k=old_kind: unfused_round(
                    torch, fops, k, src, dst, live, allowed, s_),
                3 if mode == "or" else reps),
            unfused_kernel_ms=graph_ms(
                torch, lambda: [fops.frontier_min(d_, m_, nv)
                                for d_, m_ in msg],
                3 if mode == "or" else reps))))
        del msg, got, want
        torch.cuda.empty_cache()
    return rows


def unfused_messages(torch, fops, kind, src, dst, live, allowed, st):
    """The unfused round's (dst, message) pairs, as ``core/reach.py`` built
    them before the gather moved into the kernel: int64 over every edge
    slot."""
    sent = fops.SENTINEL

    def msg_of(mask):
        return (~mask).long() * sent

    if kind == "bool":
        return [(dst, msg_of(st[src] & live))]
    if kind == "labels":
        return [(dst, torch.where(live & allowed[src], st[src].long(),
                                  sent))]
    if kind == "pair":
        return [(dst, msg_of(st[0][src] & live)),
                (src, msg_of(st[1][dst] & live))]
    return [(dst, msg_of(st[:, src] & live[None, :]))]


def unfused_round(torch, fops, kind, src, dst, live, allowed, st):
    """The unfused round bodies: ``unfused_messages``, the direct
    ``frontier_min`` of each, then the same update.  Returns (next,
    changed)."""
    nv = allowed.shape[0]
    inc = [fops.frontier_min(d, m, nv) for d, m in
           unfused_messages(torch, fops, kind, src, dst, live, allowed, st)]
    if kind == "labels":
        low = inc[0].clamp(max=2 ** 31 - 1).int()
        nxt = torch.where(allowed, torch.minimum(st, low), st)
    elif kind == "pair":
        nxt = st | (torch.stack([inc[0] == 0, inc[1] == 0])
                    & allowed[None, :])
    else:
        nxt = st | ((inc[0] == 0) & allowed)
    return nxt, (nxt != st).any()


def edge_table_checks(torch, dev, g, nv=2 ** 20, cap=2 ** 23, b=8192,
                      max_probes=64, hi_cap=2 ** 20) -> list:
    """The edge table's write path at update_1m's table (2^23 slots, 2^21
    random edges of out-degree 2, a quarter of them then removed so TOMB
    chains run through it): the boot insert of the 2^21 edges, an 8192-lane
    insert with ~10% intra-batch duplicates and an enable mask, an
    8192-lane remove with duplicates, ``compact``, ``rehash`` to 2^24, and
    an 8192-lane insert into a 2^20-slot table at ~95% load, whose lanes
    partly fail.  Each ``et.*`` call on the card is held exactly to the
    parent's path on the same inputs (its dedupe and the clones around the
    plain hash, walk and rounds, a host read per round), and the kernel
    alone to its plain version on the same columns and lanes: all three
    columns and every flag (``max_abs_err``, ``kernel_max_abs_err``: the
    largest |kernel - plain| over them).

    The whole call: ``ms``, its device time from a replayed CUDA graph;
    ``host_ms``, the call back to back; ``plain_ms``, the parent's path;
    for inserts the dedupe (``dedupe_ms``), and for inserts and rehashes
    the parent's dedupe (``parent_dedupe_ms``; a rehash no longer runs
    one) and the torch hash the kernel replaced (``torch_hash_ms``).  Its
    bound: the kernel's bytes + 18 C for an insert's clones read and
    written (2 C for remove's state; 9 C written for a rehash's fresh
    table).

    The kernel alone: ``kernel_ms`` (a graph of column copies and the
    launch, less one of the copies), ``kernel_host_ms`` and
    ``kernel_plain_ms`` (its plain version) the same way with CUDA events
    around calls.  Its bound: bytes, 11 B per lane (u, v, enable in, two
    flags out; 10 for remove) + 9 B per slot the lookup walks + 1 B per
    lane that wants a slot and 9 B per placed lane (1 B per removed
    lane).  ``launches``: the ``hash_probe`` launches of one call."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.core import edge_table as et
    from repro_torch.kernels.hash_probe import ops as hops
    from repro_torch.kernels.hash_probe import ref as href

    rng = np.random.default_rng(SEED)
    n = 2 * nv
    src = torch.from_numpy(np.repeat(np.arange(nv, dtype=np.int32), 2)).to(
        dev)
    dst = torch.from_numpy(rng.integers(0, nv, n).astype(np.int32)).to(dev)
    rows = []

    def lanes(k, pool_u, pool_v, dup=0.1):
        """k lanes: half keys from the pools, half random, then ~dup of
        the lanes repeating an earlier lane's key."""
        pick = torch.randint(0, pool_u.shape[0], (k,), generator=g,
                             device=dev)
        fresh = torch.rand(k, generator=g, device=dev) < 0.5
        u = torch.where(fresh, torch.randint(0, nv, (k,), generator=g,
                                             device=dev, dtype=torch.int32),
                        pool_u[pick])
        v = torch.where(fresh, torch.randint(0, nv, (k,), generator=g,
                                             device=dev, dtype=torch.int32),
                        pool_v[pick])
        rep = torch.rand(k, generator=g, device=dev) < dup
        earlier = (torch.rand(k, generator=g, device=dev)
                   * torch.arange(k, device=dev)).long()
        return torch.where(rep, u[earlier], u), torch.where(rep, v[earlier], v)

    def run(tag, kind, table, u, v, mp, enable=None, new_cap=None,
            reps=10):
        c_out = new_cap or table.src.shape[0]
        # the kernel's operands: lanes, enable flags, the table written into
        if kind == "rehash":
            ku, kv, raw = table.src, table.dst, table.state == et.LIVE
            into = et.empty(c_out, dev)
        else:
            ku, kv, into = u, v, table
            raw = (torch.ones(u.shape[0], dtype=torch.bool, device=dev)
                   if enable is None else enable)

        def call():
            if kind == "remove":
                return et.remove(table, u, v, mp, enable)
            if kind == "rehash":
                return et.rehash(table, c_out, mp)
            return et.insert(table, u, v, mp, enable)

        def plain():
            if kind == "remove":
                return plain_remove(torch, et, href, table, u, v, mp, enable)
            if kind == "rehash":
                return plain_rehash(torch, et, href, table, c_out, mp)
            return plain_insert(torch, et, href, table, u, v, mp, enable)

        def tensors(out):  # columns, then flags
            return list(out) if kind == "rehash" else [*out[0], *out[1:]]

        before = kernels.launch_counts()["hash_probe"]
        got = call()
        launches = kernels.launch_counts()["hash_probe"] - before
        pairs = list(zip(tensors(got), tensors(plain())))
        equal = all(torch.equal(a, b_) for a, b_ in pairs)
        check(equal, f"edge table {tag}: kernel differs from the plain path")
        err = max(max_abs_err(torch, a, b_) for a, b_ in pairs)

        en = raw & ~et._dedupe(ku, kv, raw) if kind == "insert" else raw
        wrapper, plain_fn = ((hops.remove, href.remove) if kind == "remove"
                             else (hops.insert, href.insert))
        bufs = [c.clone() for c in into]

        def copy():
            for b_, c in zip(bufs, into):
                b_.copy_(c)

        def launch(fn=wrapper):
            return fn(*bufs, ku, kv, en, max_probes=mp)

        def flags(o):  # removed, or placed, failed and rounds
            return [o] if kind == "remove" else list(o)

        copy()
        want_out = flags(launch(plain_fn)) + [c.clone() for c in bufs]
        copy()
        out = launch()
        k_pairs = list(zip(flags(out) + bufs, want_out))
        k_equal = all(torch.equal(a, b_) for a, b_ in k_pairs)
        check(k_equal, f"edge table {tag}: kernel alone differs from its "
                       f"plain version")
        k_err = max(max_abs_err(torch, a, b_) for a, b_ in k_pairs)
        visited = probe_visits(torch, into, et._hash(ku, kv, c_out), ku, kv,
                               mp, en)
        lanes_n = ku.shape[0]
        if kind == "remove":
            counts = {"removed": int(out.sum())}
            k_bytes = 10 * lanes_n + 9 * visited + counts["removed"]
            k_formula = "10 B + 9 visited + removed"
            c_bytes, c_formula = 2 * c_out + k_bytes, "2 C + kernel bytes"
        else:
            placed, failed = int(out[0].sum()), int(out[1].sum())
            counts = dict(
                rounds=int(out[2]),
                placed=placed, failed=failed,
                parent_dedupe_ms=graph_ms(
                    torch, lambda: parent_dedupe(torch, ku, kv, raw), reps),
                torch_hash_ms=graph_ms(
                    torch, lambda: et._hash(ku, kv, c_out), reps))
            if kind == "insert":
                counts["dedupe_ms"] = graph_ms(
                    torch, lambda: et._dedupe(ku, kv, raw), reps)
            k_bytes = (11 * lanes_n + 9 * visited + placed + failed
                       + 9 * placed)
            k_formula = "11 B + 9 visited + want + 9 placed"
            c_bytes, c_formula = (
                (9 * c_out + k_bytes, "9 C + kernel bytes") if kind ==
                "rehash" else (18 * c_out + k_bytes, "18 C + kernel bytes"))
        b_ms, b_by = bound_ms(c_bytes)
        kb_ms, kb_by = bound_ms(k_bytes)
        copy_ms = graph_ms(torch, copy, reps)
        k_ms = graph_ms(torch, lambda: (copy(), launch()), reps) - copy_ms
        copy_host_ms = cuda_ms(torch, copy, reps)
        row = checked_row(dict(
            case=tag, shape=f"C={c_out} B={lanes_n} max_probes={mp}",
            **counts, slots_visited=visited, tolerance="exact", equal=equal,
            max_abs_err=err, launches=launches,
            ms=graph_ms(torch, call, reps), host_ms=cuda_ms(torch, call, reps),
            plain_ms=cuda_ms(torch, plain, 2), library_ms=None,
            bound_ms=b_ms, bound_by=b_by, bound_formula=c_formula,
            bound_bytes=c_bytes,
            kernel_equal=k_equal, kernel_max_abs_err=k_err, kernel_ms=k_ms,
            kernel_host_ms=(cuda_ms(torch, lambda: (copy(), launch()), reps)
                            - copy_host_ms),
            kernel_plain_ms=(cuda_ms(torch, lambda: (copy(),
                                                     launch(plain_fn)), 2)
                             - cuda_ms(torch, copy, 2)),
            kernel_bound_ms=kb_ms, kernel_bound_by=kb_by,
            kernel_bound_formula=k_formula, kernel_bound_bytes=k_bytes))
        row["share"] = row["bound_ms"] / row["ms"]
        row["kernel_share"] = kb_ms / k_ms
        check(k_ms >= kb_ms, f"edge table {tag}: the kernel's {k_ms} ms is "
                             f"below its bound")
        rows.append(row)
        del bufs, out
        return got

    empty = et.empty(cap, dev)
    table, _, _ = run("boot insert", "insert", empty, src, dst, max_probes,
                      reps=3)
    gone = torch.randperm(n, generator=g, device=dev)[:n // 4]
    table, _ = et.remove(table, src[gone], dst[gone], max_probes)
    u, v = lanes(b, torch.cat([src, src[gone]]), torch.cat([dst, dst[gone]]))
    enable = torch.rand(b, generator=g, device=dev) < 0.9
    run("insert", "insert", table, u, v, max_probes, enable)
    u, v = lanes(b, src, dst)
    run("remove", "remove", table, u, v, max_probes)
    run("compact", "rehash", table, None, None, max_probes, new_cap=cap,
        reps=3)
    run(f"rehash to C={2 * cap}", "rehash", table, None, None, max_probes,
        new_cap=2 * cap, reps=3)
    # high load: 2^20 slots filled to ~95% (a long probe bound for the
    # fill), then 8192 fresh keys at the main path's probe bound
    k = int(0.95 * hi_cap)
    fu, fv = (torch.randint(0, nv, (k,), generator=g, device=dev,
                            dtype=torch.int32) for _ in range(2))
    full, _, _ = et.insert(et.empty(hi_cap, dev), fu, fv, 4096)
    u, v = (torch.randint(0, nv, (b,), generator=g, device=dev,
                          dtype=torch.int32) for _ in range(2))
    run(f"high load ({int(et.fill_stats(full)[0])} live of {hi_cap})",
        "insert", full, u, v, max_probes)
    check(rows[-1]["failed"] > 0, "the high-load insert failed no lane")
    return rows


def parent_dedupe(torch, u, v, enable):
    """The parent's ``edge_table._dedupe``: the same lexsort, then each
    run's first enabled lane found by a ``torch.cummax`` scan."""
    order = torch.argsort(v, stable=True)
    order = order[torch.argsort(u[order], stable=True)]
    su, sv, se = u[order], v[order], enable[order]
    start = torch.ones_like(se)
    start[1:] = (su[1:] != su[:-1]) | (sv[1:] != sv[:-1])
    before = torch.cumsum(se.long(), 0) - se.long()
    at_start = torch.cummax(torch.where(start, before, 0), 0).values
    dup = torch.empty_like(se)
    dup[order] = se & (before > at_start)
    return dup


def plain_insert(torch, et, href, table, u, v, mp, enable=None):
    """The parent's ``et.insert`` on the card: its dedupe, the clones, then
    the plain hash, lookup and rounds (one host read per round)."""
    if enable is None:
        enable = torch.ones(u.shape[0], dtype=torch.bool, device=u.device)
    enable = enable & ~parent_dedupe(torch, u, v, enable)
    cols = [c.clone() for c in table]
    placed, failed, _ = href.insert(*cols, u, v, enable, max_probes=mp)
    return et.EdgeTable(*cols), placed, failed


def plain_remove(torch, et, href, table, u, v, mp, enable=None):
    """The parent's ``et.remove`` on the card."""
    if enable is None:
        enable = torch.ones(u.shape[0], dtype=torch.bool, device=u.device)
    state = table.state.clone()
    removed = href.remove(table.src, table.dst, state, u, v, enable,
                          max_probes=mp)
    return table._replace(state=state), removed


def plain_rehash(torch, et, href, table, new_cap, mp):
    """The parent's ``et.rehash`` on the card."""
    return plain_insert(torch, et, href, et.empty(new_cap, table.src.device),
                        table.src, table.dst, mp,
                        table.state == et.LIVE)[0]


def visible_pairs(s: int, window: int) -> int:
    """(query, key) pairs causal attention keeps for one head of length s:
    0 <= i - j < window, window 0 meaning no limit."""
    w = s if window <= 0 else min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def lm_kernel_checks(torch, dev) -> dict:
    """flash_attention and embedding_bag against their plain versions at
    the LM and MIND shapes; returns name -> the main path's row."""
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import ops as eops
    from repro_torch.kernels.embedding_bag import ref as eref
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.flash_attention import ref as aref

    g = torch.Generator(device=dev).manual_seed(SEED)
    out = {}

    # flash_attention: one qwen3-14b prefill layer (the LM main path's
    # shape), danube's window at a length where it bites, a ragged f32 case
    rows = []
    for tag, b, h, hkv, s, d, window, dtype, tol, reps in (
            ("qwen3-14b prefill layer", 4, 40, 8, 4096, 128, 0,
             torch.bfloat16, 3e-2, 10),
            ("h2o-danube-3-4b", 1, 32, 8, 8192, 120, 4096, torch.bfloat16,
             3e-2, 10),
            ("ragged f32", 2, 8, 4, 1000, 16, 0, torch.float32, 2e-5, 10)):
        # q as the LM hands it over: a [B,S,H,D] buffer viewed as [B,H,S,D]
        bufs = [torch.randn((b, s, n, d), generator=g, device=dev).to(dtype)
                for n in (h, hkv, hkv)]
        q, k, v = (x.transpose(1, 2) for x in bufs)
        got = aops.mha(q, k, v, causal=True, window=window)
        want = aref.mha(q, k, v, causal=True, window=window)
        check(bool(torch.isfinite(got).all()), f"flash {tag}: not finite")
        check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
              f"flash {tag} disagrees with its plain version")
        acc = {"max_abs_err": float((got.float() - want.float()).abs().max())}
        del want
        if dtype != torch.float32:
            acc.update(flash_f32_checks(torch, aops, aref, bufs, got, window))
        del got, bufs
        torch.cuda.empty_cache()
        # the library yardstick: SDPA on kv repeated to H heads (outside
        # the timing), causal, or with an explicit band mask for the window
        kr, vr = (x.repeat_interleave(h // hkv, dim=1) for x in (k, v))
        if window > 0:
            ij = (torch.arange(s, device=dev)[:, None]
                  - torch.arange(s, device=dev)[None, :])
            band = (ij >= 0) & (ij < window)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, kr, vr, attn_mask=band)
        else:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, kr, vr, is_causal=True)
        esize = q.element_size()
        pairs = visible_pairs(s, window)
        b_ms, b_by = bound_ms(
            esize * d * s * b * (2 * h + 2 * hkv), 4 * d * pairs * b * h,
            BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
        rows.append(checked_row(dict(
            shape=f"{tag}: B={b} H={h} Hkv={hkv} S={s} D={d} causal "
                  f"window={window} {str(dtype).removeprefix('torch.')} "
                  f"visible_pairs_per_head={pairs}",
            tolerance=tol, **acc,
            ms=graph_ms(torch, lambda: aops.mha(q, k, v, window=window),
                        reps),
            host_ms=cuda_ms(torch, lambda: aops.mha(q, k, v, window=window),
                            reps),
            plain_ms=cuda_ms(torch, lambda: aref.mha(q, k, v, window=window),
                             2),
            library_ms=graph_ms(torch, lib, reps), bound_ms=b_ms,
            bound_by=b_by)))
        del q, k, v, kr, vr, lib
        torch.cuda.empty_cache()
    emit("kernel", name="flash_attention", rows=rows)
    out["flash_attention"] = rows[0]
    emit("flash_band_checks", rows=flash_band_checks(torch, aops, aref, g,
                                                     dev))

    # embedding_bag: MIND's item table (2^21 x 64 f32) and serve_p99 bags
    # (512 x 50), ~20% padding; sum, weighted sum and mean
    table, ids = mind_table(torch, dev, g), mind_ids(torch, dev, g)
    wts = torch.rand(ids.shape, generator=g, device=dev)
    valid = (ids >= 0) & (ids < table.shape[0])
    nnz = int(valid.sum())
    safe_ids = torch.where(valid, ids, torch.zeros_like(ids))
    n_ids = (ids >= 0).sum(1, keepdim=True).clamp_min(1).float()
    rows = []
    for mode, weights in (("sum", None), ("sum", wts), ("mean", None)):
        got = eops.embedding_bag(table, ids, mode=mode, weights=weights)
        want = eref.embedding_bag(table, ids, mode=mode, weights=weights)
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
              f"embedding_bag {mode} disagrees with its plain version")
        # the library yardstick: one F.embedding_bag sum whose per-sample
        # weights fold in the padding, the weights and the mean's divisor
        eff = (valid.float() if weights is None else weights * valid) / (
            n_ids if mode == "mean" else 1.0)
        b_ms, b_by = bound_ms(ids.numel() * (4 if weights is None else 8)
                              + nnz * table.shape[1] * 4
                              + got.numel() * 4)
        call = (lambda m=mode, w=weights: eops.embedding_bag(
            table, ids, mode=m, weights=w))
        rows.append(checked_row(dict(
            shape=f"{mode}{'' if weights is None else ' weighted'}: "
                  f"V={table.shape[0]} D={table.shape[1]} B={ids.shape[0]} "
                  f"L={ids.shape[1]} nnz={nnz}",
            tolerance=1e-5, max_abs_err=float((got - want).abs().max()),
            ms=graph_ms(torch, call, 20), host_ms=cuda_ms(torch, call, 20),
            plain_ms=cuda_ms(torch, lambda m=mode, w=weights:
                             eref.embedding_bag(table, ids, mode=m,
                                                weights=w), 20),
            library_ms=graph_ms(torch, lambda e=eff: F.embedding_bag(
                safe_ids, table, mode="sum", per_sample_weights=e), 20),
            bound_ms=b_ms, bound_by=b_by)))
    emit("kernel", name="embedding_bag", rows=rows)
    out["embedding_bag"] = rows[1]
    return out


def flash_f32_checks(torch, aops, aref, bufs, got, window) -> dict:
    """Tight checks of flash at a bf16 shape, where 3e-2 is the size of a
    typical output (rows late in a 4096-long causal softmax average ~i
    values and shrink to |out| ~ 0.03): the f32 kernel against the f32
    plain version on the same (bf16-valued) inputs in the same strided
    layout at 2e-5, and the bf16 kernel's output against that f32 answer
    at rtol 1e-2, atol 1e-2 x mean |answer|.  ``margin`` is the largest
    |error| / (atol + rtol |answer|) (a check passes at <= 1); ``late``
    reads the last half of the rows alone."""
    q32, k32, v32 = (x.float().transpose(1, 2) for x in bufs)
    got32 = aops.mha(q32, k32, v32, causal=True, window=window)
    want32 = aref.mha(q32, k32, v32, causal=True, window=window)
    del q32, k32, v32
    s = want32.shape[2]
    out = {}
    tol32 = 2e-5
    err32 = (got32 - want32).abs()
    out["f32_tolerance"] = tol32
    out["f32_max_abs_err"] = float(err32.max())
    out["f32_margin"] = float((err32 / (tol32 + tol32 * want32.abs())).max())
    check(torch.allclose(got32, want32, rtol=tol32, atol=tol32),
          f"flash f32 at {tuple(want32.shape)} disagrees with its plain "
          f"version by {out['f32_max_abs_err']}")
    del got32, err32
    out.update(bf16_vs_f32(torch, got, want32))
    out.update(
        late_mean_abs_out=float(want32[:, :, s // 2:].abs().mean()),
        bf16_vs_f32_late_max_abs_err=float(
            (got[:, :, s // 2:].float() - want32[:, :, s // 2:]).abs().max()))
    q32, k32, v32 = (x.float().transpose(1, 2) for x in bufs)
    out["p_one_bf16_term_margin"] = p_bf16_margin(torch, q32, k32, v32,
                                                  window, want32)
    del q32, k32, v32
    check(out["bf16_vs_f32_margin"] <= 1.0,
          f"flash bf16 at {tuple(want32.shape)} is off the f32 answer: "
          f"margin {out['bf16_vs_f32_margin']}")
    return out


def bf16_vs_f32(torch, got, want32) -> dict:
    """The bf16 kernel's output against the f32 answer at rtol 1e-2, atol
    1e-2 x mean |answer|; ``margin`` is the largest |error| / (atol + rtol
    |answer|) (a check passes at <= 1)."""
    mean_abs = float(want32.abs().mean())
    rtol, atol = 1e-2, 1e-2 * mean_abs
    err = (got.float() - want32).abs()
    return dict(bf16_vs_f32_rtol=rtol, bf16_vs_f32_atol=atol,
                mean_abs_out=mean_abs,
                bf16_vs_f32_max_abs_err=float(err.max()),
                bf16_vs_f32_margin=float((err / (atol + rtol * want32.abs()))
                                         .max()))


def flash_band_checks(torch, aops, aref, g, dev) -> list:
    """The bf16 kernel against the f32 plain version on the same bf16-
    valued inputs at shapes where the band edge bites: a key gained or lost
    there moves an output by about |v| / window (>= 7.7e-3 here), above the
    limit of ``bf16_vs_f32`` (~2e-3)."""
    rows = []
    for b, h, hkv, s, d, causal, window in (
            (1, 4, 2, 333, 120, True, 70), (1, 4, 1, 257, 128, False, 50),
            (1, 2, 1, 200, 16, True, 4), (2, 40, 8, 1000, 128, True, 129)):
        q, k, v = (torch.randn((b, s, n, d), generator=g, device=dev)
                   .to(torch.bfloat16).transpose(1, 2) for n in (h, hkv, hkv))
        got = aops.mha(q, k, v, causal=causal, window=window)
        want32 = aref.mha(q.float(), k.float(), v.float(), causal=causal,
                          window=window)
        row = {"shape": f"B={b} H={h} Hkv={hkv} S={s} D={d} "
                        f"causal={causal} window={window}",
               **bf16_vs_f32(torch, got, want32)}
        check(row["bf16_vs_f32_margin"] <= 1.0,
              f"flash bf16 at {row['shape']} is off the f32 answer: margin "
              f"{row['bf16_vs_f32_margin']}")
        rows.append(row)
    return rows


def p_bf16_margin(torch, q32, k32, v32, window, want32) -> float:
    """What rounding p to one bf16 term before P.V would cost: the plain
    f32 attention with p = exp(s - max) rounded to bf16 (l from the f32 p)
    against the f32 answer, as ``bf16_vs_f32`` reads it.  The kernel feeds
    P.V two bf16 terms of p instead (csrc/flash_attention.cu)."""
    h, hkv = q32.shape[1], k32.shape[1]
    k32, v32 = (x.repeat_interleave(h // hkv, dim=1) for x in (k32, v32))
    s = q32.shape[2]
    e = (q32 @ k32.transpose(-1, -2)).mul_(1.0 / q32.shape[-1] ** 0.5)
    ij = (torch.arange(s, device=e.device)[:, None]
          - torch.arange(s, device=e.device)[None, :])
    band = (ij >= 0) & ((ij < window) if window > 0 else True)
    e.masked_fill_(~band, float("-inf"))
    e.sub_(e.amax(-1, keepdim=True)).exp_()
    z = e.sum(-1, keepdim=True)
    e.copy_(e.bfloat16())
    out = (e @ v32).div_(z).bfloat16()  # f32 product (TF32 off), bf16 out
    del e
    return bf16_vs_f32(torch, out, want32)["bf16_vs_f32_margin"]


def mind_table(torch, dev, g):
    """MIND's item table: ``n_items`` 2^21 x ``embed_dim`` 64, f32."""
    return torch.randn((2 ** 21, 64), generator=g, device=dev)


def mind_ids(torch, dev, g, n_bags=512, bag_len=50):
    """One request of ``n_bags`` behaviour bags of ``bag_len`` ids (MIND's
    serve_p99 batch and seq_len), ~20% of them -1 padding."""
    ids = torch.randint(0, 2 ** 21, (n_bags, bag_len), generator=g,
                        device=dev, dtype=torch.int32)
    ids[torch.rand(ids.shape, generator=g, device=dev) < 0.2] = -1
    return ids


def probe_visits(torch, table, base, u, v, max_probes, lanes=None) -> int:
    """Slots the walk of every lane (of ``lanes`` where given) reads on
    these inputs (the data-dependent byte count of the probe bound).
    [T, C] tables take [T, B] lanes, each walking its own row."""
    cap = table.src.shape[-1]
    off = 0
    if table.src.dim() == 2:
        t, b = u.shape
        off = (torch.arange(t, device=u.device) * cap)[:, None].expand(
            t, b).reshape(-1)
        table = type(table)(*(c.reshape(-1) for c in table))
        base, u, v = base.reshape(-1), u.reshape(-1), v.reshape(-1)
        lanes = None if lanes is None else lanes.reshape(-1)
    done = (torch.zeros(u.shape[0], dtype=torch.bool, device=u.device)
            if lanes is None else ~lanes)
    visits = torch.zeros((), dtype=torch.int64, device=u.device)
    for i in range(max_probes):
        pos = (((base + i) & (cap - 1)) + off).long()
        st = table.state[pos]
        visits += (~done).sum()
        hit = (st == 1) & (table.src[pos] == u) & (table.dst[pos] == v)
        done = done | hit | (st == 0)
    return int(visits)


# -------------------------------------------------------- phases 3 - 5 ---

def boot_state(torch, dev, cfg, preload_deg):
    """``preload_deg`` random out-edges per vertex (seeded) and one static
    recompute, or every vertex a live singleton when ``preload_deg`` is 0.
    Returns (state, preloaded edge count)."""
    import numpy as np

    from repro_torch.core import dynamic
    from repro_torch.core import graph_state as gs

    nv = cfg.n_vertices
    if not preload_deg:
        return gs.all_singletons(cfg, dev), 0
    rng = np.random.default_rng(SEED)
    src = np.repeat(np.arange(nv, dtype=np.int32), preload_deg)
    dst = rng.integers(0, nv, src.shape[0]).astype(np.int32)
    state = gs.from_arrays(cfg, src, dst, device=dev)
    return dynamic.recompute(state, cfg), int(src.shape[0])


def serve_path(torch, dev, *, nv, cap, bucket, chunk, n_chunks,
               preload_deg, dense_capacity=0, budget_s=None,
               n_same=1024, record=None):
    """Boot (optional out-degree preload + recompute), then ``n_chunks``
    typed update chunks with SameSCC (``n_same``) and Reachable (32) query
    batches between them, through the port's own stream driver
    (``launch.stream.run_stream``).  Returns a report dict and the
    service; ``record`` collects every Result's (value, gen) for the
    card-vs-CPU comparison."""
    from repro_torch import kernels
    from repro_torch.configs import smscc
    from repro_torch.core import dynamic
    from repro_torch.core.service import SCCService
    from repro_torch.kernels.hash_probe import ops as hops
    from repro_torch.launch import stream

    cfg = smscc.config(n_vertices=nv, edge_capacity=cap,
                       dense_capacity=dense_capacity)
    rep = {"n_vertices": nv, "edge_capacity": cap, "bucket": bucket,
           "dense_capacity": dense_capacity}
    t0 = time.perf_counter()
    state, n_pre = boot_state(torch, dev, cfg, preload_deg)
    if n_pre:
        rep["preload_edges"] = n_pre
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
    rep["hash_probe_launches"] = {e: getattr(hops, e).launches
                                  for e in ("probe", "insert", "remove")}
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


def bag_path(torch, dev, n_requests=8) -> dict:
    """The embedding bag's own path (its wrapper is the JAX package's only
    entry to the kernel): ``n_requests`` MIND-shaped requests, each in sum,
    weighted and mean mode, counted from 0."""
    from repro_torch import kernels
    from repro_torch.kernels.embedding_bag import ops as eops
    from repro_torch.kernels.embedding_bag import ref as eref

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    table = mind_table(torch, dev, g)
    requests = [mind_ids(torch, dev, g) for _ in range(n_requests)]
    weights = torch.rand(requests[0].shape, generator=g, device=dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    outs = [eops.embedding_bag(table, ids, mode=mode, weights=w)
            for ids in requests
            for mode, w in (("sum", None), ("sum", weights), ("mean", None))]
    sync(torch, dev)
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    check(all(o.shape == (512, 64) and bool(torch.isfinite(o).all())
              for o in outs), "embedding bag path: bad output")
    want = eref.embedding_bag(table, requests[-1], mode="mean")
    check(torch.allclose(outs[-1], want, rtol=1e-5, atol=1e-5),
          "embedding bag path disagrees with its plain version")
    return {"requests": n_requests, "calls": len(outs), "seconds": seconds,
            "bags_per_s": len(outs) * 512 / seconds, "launches": launches}


def lm_path(torch, dev) -> dict:
    """Qwen3-14B at full width and depth through ``serve_lm``: 4 requests
    of 4096 prompt tokens, then 32 greedy decode steps; then one decode
    step replayed from a CUDA graph for its device time alone."""
    from repro_torch import kernels
    from repro_torch.configs import qwen3_14b
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.launch import serve

    cfg = qwen3_14b.config(attn_impl="flash")
    batch, prompt, steps = 4, 4096, 32
    kernels.reset_launch_counts()
    copies = aops.mha.layout_copies
    rep = serve.serve_lm(cfg, steps, batch=batch, prompt_len=prompt,
                         cache_len=prompt + steps, device=str(dev),
                         seed=SEED, graph_reps=8)
    rep["launches"] = kernels.launch_counts()
    rep["flash_layout_copies"] = aops.mha.layout_copies - copies
    tokens = rep.pop("tokens")
    rep["tokens_row0"] = tokens[0]
    check(rep["logits_finite"], "LM logits are not finite")
    check(len(tokens) == batch and all(
        len(t) == steps and all(0 <= x < cfg.vocab for x in t)
        for t in tokens), "LM tokens out of range")
    check(rep["launches"]["flash_attention"] == cfg.n_layers,
          f"flash launched {rep['launches']['flash_attention']} times, "
          f"expected one per layer ({cfg.n_layers})")
    check(rep["flash_layout_copies"] == 0,
          f"the prefill copied {rep['flash_layout_copies']} tensors for TMA")
    return rep


def lm_card_vs_cpu(torch, dev) -> dict:
    """The qwen3 and danube smoke configs in f32, one set of weights on
    both devices through ``carry``; prefill, then decode teacher-forced
    with the CPU's greedy tokens.  Logits must agree within 2e-4."""
    import numpy as np

    from repro_torch import carry
    from repro_torch.configs import h2o_danube_3_4b, qwen3_14b
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.models import transformer as tf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch, prompt, steps, tol = 4, 40, 8, 2e-4  # prompt > danube's window
    out = {}
    for mod in (qwen3_14b, h2o_danube_3_4b):
        cfg = mod.smoke_config(attn_impl="flash")
        tree = carry.lm_params_to_numpy(
            tf.init(cfg, torch.Generator().manual_seed(SEED), "cpu"))
        toks = np.random.default_rng(SEED).integers(
            0, cfg.vocab, (batch, prompt)).astype(np.int32)
        runs, fed = [], []
        for d in (torch.device("cpu"), dev):
            params = carry.lm_params_from_numpy(tree, cfg, d)
            before = aops.mha.launches
            cache, last = tf.prefill(params, torch.from_numpy(toks).to(d),
                                     cfg, cache_len=prompt + steps)
            seq = [last.cpu()]
            for i in range(steps):
                if d.type == "cpu":
                    fed.append(seq[-1].argmax(-1).to(torch.int32))
                step, cache = tf.decode_step(params, cache, fed[i].to(d),
                                             cfg)
                seq.append(step.cpu())
            runs.append(torch.stack(seq))
            if d.type == "cuda":
                check(aops.mha.launches - before == cfg.n_layers,
                      f"{cfg.name}: flash did not run in the card's prefill")
        cpu, card = runs
        err = float((card - cpu).abs().max())
        check(torch.allclose(card, cpu, rtol=tol, atol=tol),
              f"{cfg.name}: card and CPU logits differ by {err}")
        out[cfg.name] = {"max_abs_err": err, "logits_compared": cpu.numel()}
    return {"tolerance": tol, "prompt": prompt, "steps": steps, **out}


# ------------------------------------------------------------- phase 9 ---

def pctl(xs, q):
    import numpy as np
    return float(np.percentile(xs, q)) if len(xs) else None


class GenWatch:
    """Host time at which a service's committed generation first reached
    each value: a thread waits on the service's commit condition."""

    def __init__(self, svc):
        import threading
        self.svc = svc
        self.seen = {svc.gen: time.perf_counter()}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        g = self.svc.gen
        while not self._stop.is_set():
            now = self.svc.wait_for_gen(g + 1, timeout=0.05)
            if now > g:
                t = time.perf_counter()
                for x in range(g + 1, now + 1):
                    self.seen[x] = t
                g = now

    def close(self):
        self._stop.set()
        self._thread.join()


def durable_path(torch, dev, *, nv=2 ** 20, cap=2 ** 23, bucket=8192,
                 chunk=4 * 8192, n_chunks=8, preload_deg=2, n_same=1024,
                 replicas=2, readers=2, small=None) -> dict:
    """The durable, replicated serving path at update_1m's shape.

    The booted state (shared: no engine operation writes into a state)
    first takes the ``n_chunks`` chunks through a plain SCCService, for
    its ops/s.  Then a DurableService writer (fsync every record, a
    background snapshot every 4 generations) takes the same chunks while
    ``replicas`` WAL-tailing replicas serve ``readers`` read-your-writes
    sessions (a touch write through the writer, then ``n_same`` SameSCC at
    AT_LEAST(token)).  Each replica must reach the writer's generation
    with its state equal leaf for leaf; then the writer "crashes" (no
    close) and ``DurableService.open`` and ``scratch_replay`` (boot
    snapshot + the full WAL) must both give the writer's last committed
    state.  The launch counts are set to 0 before the writer starts and
    read after the recovery.  Then, each counted on its own: a store
    written on the card at ``small``'s shape opens bit-identically on the
    CPU (snapshot + tail, and a scratch replay from the boot snapshot);
    ``run_concurrent_stream`` with 2 readers takes the chunks and must end
    on the plain run's state; and ``serve_smscc(..., replicas=2)`` runs
    at the reference's own defaults.  Every store lives in a temporary
    directory, removed afterwards."""
    import os
    import tempfile
    import threading

    import numpy as np

    from repro_torch import kernels
    from repro_torch.api import (AddEdge, Consistency, GraphClient,
                                 RemoveEdge, SameSCC)
    from repro_torch.ckpt import oplog
    from repro_torch.ckpt.durable import (DurableService, scratch_replay,
                                          snap_dir, wal_dir)
    from repro_torch.configs import smscc
    from repro_torch.core.replicas import ReplicaSet
    from repro_torch.core.service import SCCService
    from repro_torch.launch import serve, stream
    from repro_torch.launch.replica import states_equal

    small = small or dict(nv=2 ** 14, cap=2 ** 16, bucket=1024, chunk=4096,
                          n_chunks=3)
    cuda = dev.type == "cuda"
    cfg = smscc.config(n_vertices=nv, edge_capacity=cap)
    knobs = dict(buckets=(8, bucket), scan_lengths=smscc.SCAN_LENGTHS,
                 proactive_grow=True)
    rep = {"n_vertices": nv, "edge_capacity": cap, "bucket": bucket,
           "chunk": chunk, "chunks": n_chunks, "replicas": replicas,
           "readers": readers}
    t0 = time.perf_counter()
    boot, rep["preload_edges"] = boot_state(torch, dev, cfg, preload_deg)
    sync(torch, dev)
    rep["boot_s"] = time.perf_counter() - t0

    def feed(svc, cfg=cfg, chunk=chunk, n_chunks=n_chunks):
        """The typed chunks through one GraphClient; seconds to a
        synchronise."""
        client = GraphClient(svc)
        t0 = time.perf_counter()
        for step in range(n_chunks):
            client.submit_many(stream.typed_op_stream(
                cfg.n_vertices, chunk, step=step, add_frac=0.7, seed=SEED))
        sync(torch, dev)
        seconds = time.perf_counter() - t0
        client.close()
        return seconds

    plain = SCCService(cfg, state=boot, **knobs)
    rep["plain_s"] = feed(plain)
    rep["plain_ops_per_s"] = n_chunks * chunk / rep["plain_s"]
    plain_state = plain.state
    del plain

    fsync_ms = []
    real_fsync = oplog.fs_fsync

    def timed_fsync(f):
        t = time.perf_counter()
        real_fsync(f)
        fsync_ms.append((time.perf_counter() - t) * 1e3)

    with tempfile.TemporaryDirectory(prefix="scc-durable-") as tmp:
        store = os.path.join(tmp, "store")
        oplog.fs_fsync = timed_fsync  # every WAL fsync, timed
        try:
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            writer = DurableService(
                cfg, store, state=boot, sync_every=1, snapshot_every=4,
                snapshot_keep=10 ** 6, trim_on_snapshot=False, **knobs)
            rep["boot_snapshot_s"] = time.perf_counter() - t0
            boot_gen = writer.gen  # the recompute took one generation
            rep["snapshot_bytes"] = os.path.getsize(  # the boot snapshot
                os.path.join(snap_dir(store), f"ckpt_{boot_gen}.npz"))
            rset = ReplicaSet(store, replicas, query_buckets=(n_same,),
                              poll_interval=0.01, device=dev,
                              scan_lengths=smscc.SCAN_LENGTHS)
            watches = [GenWatch(writer)] + [GenWatch(r.service)
                                            for r in rset.replicas]
            stop = threading.Event()
            rounds = [[] for _ in range(readers)]
            errors = []

            def reader(i):
                wclient = GraphClient(writer)
                rclient = GraphClient(writer, broker=rset)
                rng = np.random.default_rng(SEED + 7919 * (i + 1))
                flip, last = False, 0
                try:
                    while not stop.is_set():
                        t = time.perf_counter()
                        op = (RemoveEdge if flip else AddEdge)(2 * i,
                                                               2 * i + 1)
                        flip = not flip
                        token = wclient.submit_many([op])[0].gen
                        floor = max(token, last)
                        qu = rng.integers(0, nv, n_same)
                        qv = rng.integers(0, nv, n_same)
                        res = rclient.submit_many(
                            [SameSCC(int(a), int(b)) for a, b in
                             zip(qu, qv)],
                            consistency=Consistency.AT_LEAST(floor))
                        if res[0].gen < floor:
                            raise CheckFailed(f"reader {i}: stamp "
                                              f"{res[0].gen} < {floor}")
                        last = res[0].gen
                        rounds[i].append((time.perf_counter() - t) * 1e3)
                except Exception as e:
                    errors.append(e)

            threads = [threading.Thread(target=reader, args=(i,),
                                        daemon=True)
                       for i in range(readers)]
            for t in threads:
                t.start()
            try:
                rep["writer_s"] = feed(writer)
            finally:
                stop.set()
                for t in threads:
                    t.join()
            if errors:
                raise errors[0]
            rep["writer_ops_per_s"] = n_chunks * chunk / rep["writer_s"]
            final_gen, final_state = writer.gen, writer.state
            t0 = time.perf_counter()
            rset.wait_all_for_gen(final_gen, timeout=600)
            rep["replica_catch_up_s"] = time.perf_counter() - t0
            for w in watches:
                w.close()
            for r in rset.replicas:
                check(r.gen == final_gen, f"replica {r.replica_id} at gen "
                      f"{r.gen}, writer at {final_gen}")
                check(states_equal(r.service.state, final_state),
                      f"replica {r.replica_id} differs from the writer")
            lag = [(w.seen[g] - watches[0].seen[g]) * 1e3
                   for w in watches[1:] for g in watches[0].seen
                   if g in w.seen and g > 0]
            rs = rset.stats()
            rset.stop()
            rep.update(
                gen=final_gen, replicas_equal_writer=True,
                touches=sum(len(r) for r in rounds),
                ryw_round_ms_p50=pctl(sum(rounds, []), 50),
                ryw_round_ms_p99=pctl(sum(rounds, []), 99),
                replica_lag_ms_p50=pctl(lag, 50),
                replica_lag_ms_p99=pctl(lag, 99),
                replica_lag_samples=len(lag),
                routed_fresh=rs["routed_fresh"],
                routed_stale=rs["routed_stale"],
                replica_gen_waits=rs["gen_waits"])
            if cuda:
                rep["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)

            # crash: no close; the background snapshot in flight is let
            # finish, the WAL is left open as a killed process leaves it
            writer.crash()
            if writer._snap_thread is not None:
                writer._snap_thread.join()
            rep["snapshots"] = writer.snapshot_count
            rep["last_snapshot_gen"] = writer._last_snap_gen
            segs = oplog.list_segments(wal_dir(store))
            rep["wal_bytes"] = sum(os.path.getsize(p) for _, p in segs)
            rep["wal_records"] = len(oplog.read_log(wal_dir(store)))
            rep["fsyncs"] = len(fsync_ms)
            rep["fsync_ms_p50"] = pctl(fsync_ms, 50)
            rep["fsync_ms_p99"] = pctl(fsync_ms, 99)
            t0 = time.perf_counter()
            rec = DurableService.open(store, device=dev, snapshot_every=0,
                                      scan_lengths=smscc.SCAN_LENGTHS)
            sync(torch, dev)
            rep["recovery_s"] = time.perf_counter() - t0
            rep["recovery_restore_s"] = rec.restore_s
            rep["recovery_replay_s"] = rec.replay_s
            rep["recovery_replayed_records"] = rec.replayed_wal_records
            check(rec.gen == final_gen and
                  states_equal(rec.state, final_state),
                  f"recovery at gen {rec.gen} differs from the writer's "
                  f"last commit (gen {final_gen})")
            rec.close()
            t0 = time.perf_counter()
            scr = scratch_replay(store, from_step=boot_gen, device=dev)
            sync(torch, dev)
            rep["scratch_replay_s"] = time.perf_counter() - t0
            check(scr.gen == final_gen and
                  states_equal(scr.state, final_state),
                  "scratch replay differs from the writer's last commit")
            rep["launches"] = kernels.launch_counts()
        finally:
            oplog.fs_fsync = real_fsync
        del writer, rset, rec, scr, final_state
        if cuda:
            torch.cuda.empty_cache()

        # a store written on the card opens bit-identically on the CPU
        t0 = time.perf_counter()
        s_cfg = smscc.config(n_vertices=small["nv"],
                             edge_capacity=small["cap"])
        s_boot, _ = boot_state(torch, dev, s_cfg, preload_deg)
        s_store = os.path.join(tmp, "small")
        s_writer = DurableService(
            s_cfg, s_store, state=s_boot, sync_every=1, snapshot_every=8,
            snapshot_keep=10 ** 6, trim_on_snapshot=False,
            buckets=(8, small["bucket"]), scan_lengths=smscc.SCAN_LENGTHS,
            proactive_grow=True)
        feed(s_writer, s_cfg, small["chunk"], small["n_chunks"])
        s_writer.close()
        cpu = torch.device("cpu")
        on_cpu = DurableService.open(s_store, device=cpu, snapshot_every=0)
        cpu_scr = scratch_replay(s_store, from_step=int(s_boot.gen),
                                 device=cpu)
        same = {"open": on_cpu.gen == s_writer.gen and
                states_equal(on_cpu.state, s_writer.state),
                "scratch_replay": cpu_scr.gen == s_writer.gen and
                states_equal(cpu_scr.state, s_writer.state)}
        rep["card_store_on_cpu"] = dict(
            n_vertices=small["nv"], edge_capacity=small["cap"],
            gen=s_writer.gen, cpu_replayed_records=on_cpu.replayed_wal_records,
            seconds=time.perf_counter() - t0, **same)
        check(all(same.values()),
              f"a store written on the card opens differently on the CPU: "
              f"{same}")
        on_cpu.close()
        del s_writer, on_cpu, cpu_scr, s_boot

        # concurrent readers over one broker, at update_1m
        svc = SCCService(cfg, state=boot, **knobs)
        kernels.reset_launch_counts()
        cc = stream.run_concurrent_stream(
            svc, n_chunks * chunk, readers=2, add_frac=0.7, chunk=chunk,
            n_queries=n_same, reach_queries=32, seed=SEED)
        rep["concurrent"] = dict(
            {k: cc[k] for k in ("ops", "queries", "readers", "wall_s",
                                "ops_per_s", "queries_per_s",
                                "combined_per_s", "gen", "flushes",
                                "gen_waits")},
            launches=kernels.launch_counts())
        check(states_equal(svc.state, plain_state),
              "the concurrent run ended off the plain run's state")
        del svc

        # the serve entry point at the reference's own defaults
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        srv = serve.serve_smscc(32, replicas=2,
                                directory=os.path.join(tmp, "serve"),
                                device=str(dev))
        rep["serve_replicas"] = dict(
            {k: srv[k] for k in ("replicas", "readers", "ops", "touches",
                                 "queries", "ops_per_s", "queries_per_s",
                                 "combined_per_s", "routed_fresh",
                                 "routed_stale")},
            seconds=time.perf_counter() - t0,
            launches=kernels.launch_counts())
    return rep


# ------------------------------------------------------------ phase 10 ---

def tenant_ops(nv, chunk, waves, seed):
    """One tenant's ``waves`` chunks of the paper's mix, as (kind, u, v)
    numpy arrays (the typed stream's own draws)."""
    import numpy as np

    from repro_torch.launch import workload
    out = []
    for w in range(waves):
        ops = workload.op_stream(nv, chunk, step=w, add_frac=0.7, seed=seed)
        out.append(tuple(np.asarray(x, np.int32) for x in ops))
    return out


def boot_lanes(torch, dev, cfg, n, preload_deg, seed0):
    """``n`` stacked tenant states: each with ``preload_deg`` random
    out-edges per vertex (tenant i seeded ``seed0 + i``, one lane-batched
    insert for all) and one lane-batched static recompute; or every
    vertex a live singleton when ``preload_deg`` is 0.  Returns (stacked
    state, tenant 0's src, dst)."""
    import numpy as np

    from repro_torch.core import dynamic, edge_table as et
    from repro_torch.core import graph_state as gs

    nv = cfg.n_vertices
    if not preload_deg:
        return gs.stack([gs.all_singletons(cfg, dev)] * n), None, None
    src = np.repeat(np.arange(nv, dtype=np.int32), preload_deg)
    dst = np.stack([np.random.default_rng(seed0 + i).integers(
        0, nv, src.shape[0]).astype(np.int32) for i in range(n)])
    tsrc = torch.from_numpy(np.broadcast_to(src, dst.shape).copy()).to(dev)
    tdst = torch.from_numpy(dst).to(dev)
    empty = gs.stack([gs.empty(cfg, dev)] * n)
    edges, _, failed = et.insert(empty.edges, tsrc, tdst, cfg.max_probes)
    state = empty._replace(
        v_alive=torch.ones((n, nv), dtype=torch.bool, device=dev),
        edges=edges, overflow=failed.sum(1).int())
    return dynamic.recompute(state, cfg), src, dst[0]


def lane_kernel_rows(torch, dev, boot, ops, cfg, reps=10) -> dict:
    """The two tenant-row kernels alone at the tenant path's class-A shape
    (T tenants x C slots, NV vertices): frontier_min's boolean round
    (seeds 1% of each lane's vertices) and hash_probe's insert of the
    first wave's AddEdge lanes (T x chunk) into the booted tables.  Each
    held exactly to its plain version on the card; device ms from a
    replayed CUDA graph, host ms back to back, plain ms, and the byte
    bound (gather: 9 B per edge slot + 8 B per vertex; insert: 11 B per
    lane + 9 per slot walked + want + 9 per placed lane)."""
    import numpy as np

    from repro_torch.core import edge_table as et
    from repro_torch.core import reach
    from repro_torch.kernels.frontier_expand import ops as fops
    from repro_torch.kernels.frontier_expand import ref as fref
    from repro_torch.kernels.hash_probe import ops as hops
    from repro_torch.kernels.hash_probe import ref as href

    t_n, cap = boot.edges.src.shape
    nv = cfg.n_vertices
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    src, dst = boot.edges.src, boot.edges.dst
    live = boot.edges.state == et.LIVE
    seeds = torch.rand((t_n, nv), generator=g, device=dev) < 0.01
    val = reach._reached_val(seeds & boot.v_alive)

    def gather(fn=fops.frontier_gather):
        return fn(src, dst, live, val.unsqueeze(1), nv)

    got = gather()
    want = gather(lambda *a: fref.frontier_gather_lanes(*a, "min"))
    check(torch.equal(got, want), "lane gather differs from its plain "
                                  "version")
    b_ms, b_by = bound_ms(9 * t_n * cap + 8 * t_n * nv)
    rows = {"frontier_min": checked_row(dict(
        shape=f"boolean round, T={t_n} rows of C={cap} slots, NV={nv}",
        max_abs_err=max_abs_err(torch, got, want),
        ms=graph_ms(torch, gather, reps), host_ms=cuda_ms(torch, gather,
                                                          reps),
        plain_ms=cuda_ms(torch, lambda: gather(
            lambda *a: fref.frontier_gather_lanes(*a, "min")), 3),
        library_ms=None, bound_ms=b_ms, bound_by=b_by))}

    kind = torch.from_numpy(np.stack([o[0][0] for o in ops])).to(dev)
    u = torch.from_numpy(np.stack([o[0][1] for o in ops])).to(dev)
    v = torch.from_numpy(np.stack([o[0][2] for o in ops])).to(dev)
    raw = kind == 0  # AddEdge lanes
    en = raw & ~et._dedupe(u, v, raw)
    bufs = [c.clone() for c in boot.edges]

    def copy():
        for b_, c in zip(bufs, boot.edges):
            b_.copy_(c)

    def launch(fn=hops.insert):
        return fn(*bufs, u, v, en, max_probes=cfg.max_probes)

    copy()
    want = list(launch(href.insert)) + [c.clone() for c in bufs]
    copy()
    out = launch()
    pairs = list(zip(list(out) + bufs, want))
    check(all(torch.equal(a, b_) for a, b_ in pairs),
          "lane insert differs from its plain version")
    err = max(max_abs_err(torch, a, b_) for a, b_ in pairs)
    visited = probe_visits(torch, boot.edges, et._hash(u, v, cap), u, v,
                           cfg.max_probes, en)
    placed, failed = int(out[0].sum()), int(out[1].sum())
    k_bytes = 11 * u.numel() + 9 * visited + placed + failed + 9 * placed
    kb_ms, kb_by = bound_ms(k_bytes)
    copy_ms = graph_ms(torch, copy, reps)
    copy_host_ms = cuda_ms(torch, copy, reps)
    rows["hash_probe"] = checked_row(dict(
        shape=f"insert kernel alone, T={t_n} rows of C={cap} slots x "
              f"{u.shape[1]} lanes, {int(out[2])} rounds, {visited} slots "
              f"walked", rounds=int(out[2]), placed=placed, failed=failed,
        max_abs_err=err,
        ms=graph_ms(torch, lambda: (copy(), launch()), reps) - copy_ms,
        host_ms=cuda_ms(torch, lambda: (copy(), launch()), reps)
        - copy_host_ms,
        plain_ms=cuda_ms(torch, lambda: (copy(), launch(href.insert)), 2)
        - cuda_ms(torch, copy, 2),
        library_ms=None, bound_ms=kb_ms, bound_by=kb_by,
        bound_bytes=k_bytes))
    return rows


def tenant_path(torch, dev, *, nv=4096, cap_a=2 ** 14, n_a=256,
                cap_b=2 ** 13, n_b=64, cap_s=1024, chunk=1024, waves=8,
                t_small=8, small_nv=256, sample=4) -> dict:
    """Multi-tenant SMSCC serving on the card (phase 10).

    A ``TenantEngine(buckets=(chunk,), tenant_batches=(1, 8, 64, 256))``
    holds class A (``n_a`` tenants, ``smscc.config(nv, cap_a)``, each
    preloaded with out-degree-2 random edges: a giant SCC, the full tier),
    class B (``n_b`` tenants at ``cap_b``, every vertex a live singleton
    and no edge: the compact tier carries its steps) and one tenant booted
    at ``cap_s`` slots, which overflows, replays solo and migrates to a
    grown class.  ``waves`` waves of one ``chunk``-op chunk per tenant of
    the paper's mix (add_frac 0.7) go through ``apply_chunks``; the launch
    counts are set to 0 just before and read just after.  Checks: every
    tenant's acks, generations, config and final state equal a port
    ``SCCService`` of its own fed the same chunks on the card (that run's
    wall time gives the sequential ops/s); maintained labels equal a
    static recompute for ``sample`` tenants; the compact tier and a solo
    replay ran.  Then: host syncs per wave of class A at T = ``n_a``
    against a ``t_small``-tenant engine on the same traffic; 8 tenants
    at ``small_nv`` vertices on the card equal the same on the CPU;
    ``serve_tenants`` at the reference's defaults, plain and durable
    (the card-written stores open equal on the CPU); one
    ``run_chaos_soak`` seed at its smoke size."""
    import os
    import tempfile

    import numpy as np

    from repro_torch import kernels
    from repro_torch.ckpt.durable import DurableService
    from repro_torch.configs import smscc
    from repro_torch.core import dynamic
    from repro_torch.core import graph_state as gs
    from repro_torch.core.service import SCCService
    from repro_torch.core.sync import SYNCS
    from repro_torch.launch import chaos, serve
    from repro_torch.launch.replica import states_equal
    from repro_torch.tenancy import TenantEngine

    cuda = dev.type == "cuda"
    cfgs = {"a": smscc.config(n_vertices=nv, edge_capacity=cap_a),
            "b": smscc.config(n_vertices=nv, edge_capacity=cap_b),
            "s": smscc.config(n_vertices=nv, edge_capacity=cap_s)}
    counts = {"a": n_a, "b": n_b, "s": 1}
    rep = {"n_vertices": nv, "tenants": {k: (counts[k], c.edge_capacity)
                                         for k, c in cfgs.items()},
           "chunk": chunk, "waves": waves}
    t0 = time.perf_counter()
    boot_a, src0, dst0 = boot_lanes(torch, dev, cfgs["a"], n_a, 2, SEED)
    boots = {"a": boot_a,
             "b": boot_lanes(torch, dev, cfgs["b"], n_b, 0, 0)[0],
             "s": gs.stack([gs.all_singletons(cfgs["s"], dev)])}
    sync(torch, dev)
    rep["boot_s"] = time.perf_counter() - t0
    # the lane-batched boot == tenant 0 booted alone
    solo0 = dynamic.recompute(gs.from_arrays(cfgs["a"], src0, dst0,
                                             device=dev), cfgs["a"])
    check(states_equal(gs.lane(boot_a, 0), solo0),
          "lane-batched boot differs from a solo boot")
    tids = [f"{k}{i}" for k in ("a", "b", "s") for i in range(counts[k])]
    ops = {tid: tenant_ops(nv, chunk, waves, SEED + 1000 + j)
           for j, tid in enumerate(tids)}
    rep["kernels"] = lane_kernel_rows(
        torch, dev, boot_a, [ops[f"a{i}"] for i in range(n_a)], cfgs["a"])

    def engine(names):
        eng = TenantEngine(buckets=(chunk,), tenant_batches=(1, 8, 64, 256),
                           device=dev)
        for tid in names:
            eng.create_tenant(tid, cfgs[tid[0]],
                              state=gs.lane(boots[tid[0]], int(tid[1:])),
                              gen=1 if tid[0] == "a" else 0)
        return eng

    def run_waves(eng, names):
        acks, walls, syncs = [], [], []
        for w in range(waves):
            s0, t0 = SYNCS.count, time.perf_counter()
            res = eng.apply_chunks([(tid, *ops[tid][w]) for tid in names])
            sync(torch, dev)
            walls.append(time.perf_counter() - t0)
            syncs.append(SYNCS.count - s0)
            acks.append(res)
        return acks, walls, syncs

    eng = engine(tids)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    acks, walls, syncs = run_waves(eng, tids)
    rep["launches"] = kernels.launch_counts()
    rep["lane_launches"] = kernels.lane_launch_counts()
    if cuda:
        rep["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    st = eng.stats()
    n_ops = len(tids) * waves * chunk
    rep.update(
        update_s=sum(walls), ops=n_ops, ops_per_s=n_ops / sum(walls),
        wave_s=walls, host_syncs_per_wave=syncs,
        host_syncs_by_capacity=st["host_syncs_by_capacity"],
        lane_steps=st["lane_steps"],
        repair_lane_steps=st["repair_lane_steps"],
        dispatches=st["dispatches"], solo_replays=st["solo_replays"],
        compile_count=st["compile_count"],
        compile_bound=st["compile_bound"],
        occupancy=st["occupancy"],
        small_tenant=eng.tenant_telemetry("s0"))
    check(st["repair_lane_steps"]["compact"] > 0, "the compact tier never "
                                                  "ran")
    check(st["solo_replays"] > 0, "no solo replay ran")
    check(eng.tenant_cfg("s0").edge_capacity > cap_s,
          "the undersized tenant did not grow")
    check(st["compile_count"] <= st["compile_bound"], "registry bound")

    # the oracle: one port SCCService per tenant, the same chunks
    t0 = time.perf_counter()
    for tid in tids:
        svc = SCCService(cfgs[tid[0]], buckets=(chunk,),
                         state=gs.lane(boots[tid[0]], int(tid[1:])))
        for w in range(waves):
            ok, gen = svc._apply_ops(*ops[tid][w])
            got_ok, got_gen = acks[w][tid]
            check(np.array_equal(got_ok, ok) and got_gen == gen,
                  f"{tid} wave {w}: acks or gen differ from its oracle")
        check(svc.cfg == eng.tenant_cfg(tid), f"{tid}: config differs")
        check(states_equal(eng.tenant_state(tid), svc.state),
              f"{tid}: state differs from its single-tenant oracle")
    sync(torch, dev)
    rep["sequential_s"] = time.perf_counter() - t0
    rep["sequential_ops_per_s"] = n_ops / rep["sequential_s"]
    rep["engine_vs_sequential"] = rep["ops_per_s"] / \
        rep["sequential_ops_per_s"]
    for tid in ("a0", f"a{n_a - 1}", "b0", "s0")[:sample]:
        state, cfg = eng.tenant_state(tid), eng.tenant_cfg(tid)
        check(torch.equal(dynamic.recompute(state, cfg).ccid, state.ccid),
              f"{tid}: maintained labels differ from a static recompute")
    del eng

    # host syncs against T: class A alone at t_small tenants
    small = [f"a{i}" for i in range(t_small)]
    _, _, syncs_small = run_waves(engine(small), small)
    per_wave_big = st["host_syncs_by_capacity"][cap_a] / waves
    per_wave_small = sum(syncs_small) / waves
    rep["class_a_syncs_per_wave"] = {n_a: per_wave_big,
                                     t_small: per_wave_small}
    check(per_wave_big <= 2 * per_wave_small,
          f"host syncs per wave grew with T: {per_wave_big} at T={n_a} vs "
          f"{per_wave_small} at T={t_small}")

    # card against CPU: 8 tenants at small_nv vertices
    scfg = smscc.config(n_vertices=small_nv, edge_capacity=4 * small_nv)
    runs = []
    for d in (dev, torch.device("cpu")):
        e2 = TenantEngine(buckets=(64,), tenant_batches=(1, 8), device=d)
        for i in range(8):
            e2.create_tenant(f"c{i}", scfg,
                             state=gs.all_singletons(scfg, d))
        out = []
        for w in range(6):
            res = e2.apply_chunks([
                (f"c{i}", *tenant_ops(small_nv, 64, w + 1, 7 + i)[w])
                for i in range(8)])
            out.append([(res[f"c{i}"][0].tolist(), res[f"c{i}"][1])
                        for i in range(8)])
        runs.append((out, [e2.tenant_state(f"c{i}") for i in range(8)]))
    check(runs[0][0] == runs[1][0] and all(
        states_equal(a, b) for a, b in zip(runs[0][1], runs[1][1])),
        "tenant engine on the card differs from the CPU")
    rep["card_vs_cpu_tenants"] = 8

    # the serve paths (the reference's defaults) and a chaos soak
    t0 = time.perf_counter()
    agg = serve.serve_tenants(32, 4, device=dev.type)
    rep["serve"] = {"wall_s": agg["wall_s"], "ops": agg["ops"],
                    "waves": agg["queue"]["waves"],
                    "solo_replays": agg["engine"]["solo_replays"]}
    with tempfile.TemporaryDirectory(prefix="scc-tenants-") as tmp:
        agg = serve.serve_tenants(32, 4, directory=tmp, device=dev.type)
        for tid, (state, gen) in agg["final"].items():
            d = DurableService.open(os.path.join(tmp, "tenants", tid),
                                    snapshot_every=0, device="cpu")
            check(d.gen == gen and states_equal(d.state, state),
                  f"{tid}: the card-written store opens differently on "
                  f"the CPU")
            d.close()
        rep["serve_durable"] = {"wall_s": agg["wall_s"], "ops": agg["ops"],
                                "stores_opened_on_cpu": len(agg["final"])}
    with tempfile.TemporaryDirectory(prefix="scc-chaos-") as tmp:
        soak = chaos.run_chaos_soak(tmp, seed=0, profile="mixed",
                                    n_chunks=28, nv=160, device=dev)
    check(soak["violations"] == [], f"chaos soak: {soak['violations']}")
    rep["chaos"] = {k: soak[k] for k in (
        "acked", "gen", "fs_triggered", "kills_fired", "degraded",
        "recovered", "client_retries", "restarts")}
    rep["chaos"]["failed"] = len(soak["failed"])
    rep["serve_and_chaos_s"] = time.perf_counter() - t0
    return rep


def sass_counts(build, name, ops) -> dict:
    """Lines of ``cuobjdump -sass`` of a built kernel library that hold
    each opcode."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lines = subprocess.run(
        [cuobjdump, "-sass", str(build._target(name)[1])],
        capture_output=True, text=True, check=True,
        timeout=120).stdout.splitlines()
    return {op: sum(op in ln for ln in lines) for op in ops}


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
    sass = {name: sass_counts(_build, name, ops)
            for name, ops in TENSOR_CORE_OPS.items()}
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={k: v[1] for k, v in _build.build_log.items()},
         tensor_core_instructions=sass)
    for name, counts in sass.items():
        check(sum(counts.values()) > 0,
              f"{name}: no tensor-core instruction in its SASS: {counts}")

    t0 = time.perf_counter()
    kern = kernel_checks(torch, dev)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    et_rows = edge_table_checks(
        torch, dev, torch.Generator(device=dev).manual_seed(SEED + 2))
    emit("edge_table", seconds=time.perf_counter() - t1, rows=et_rows)
    # the main path's own form: the kernel of an update step's 8192-lane
    # insert, alone (the whole et.insert call stays in its edge_table row)
    r = et_rows[1]
    kern["hash_probe"] = dict(
        shape=f"{r['shape']} (insert entry, kernel alone)",
        max_abs_err=r["kernel_max_abs_err"], ms=r["kernel_ms"],
        host_ms=r["kernel_host_ms"], plain_ms=r["kernel_plain_ms"],
        bound_ms=r["kernel_bound_ms"], bound_by=r["kernel_bound_by"],
        library_ms=None)
    torch.cuda.empty_cache()
    # before the model is loaded: the plain attention at the qwen3 shape
    # holds a [4, 40, 4096, 4096] f32 score tensor (10.7 GB)
    kern.update(lm_kernel_checks(torch, dev))
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
    check(main_rep["hash_probe_launches"]["insert"] > 0,
          "hash_probe's insert entry never launched")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dense_rep, _ = serve_path(torch, dev, nv=2 ** 14, cap=2 ** 16,
                              bucket=256, chunk=1024, n_chunks=8,
                              preload_deg=0, dense_capacity=512,
                              n_same=256)
    emit("dense_tier", seconds=time.perf_counter() - t0, **dense_rep)
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
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dur = durable_path(torch, dev)
    dur["seconds"] = time.perf_counter() - t0
    dur["main_path"] = {k: main_rep[k] for k in
                        ("ops_per_s", "queries_per_s")}
    emit("durable_path", **dur)
    for k in ("frontier_min", "hash_probe"):
        check(dur["launches"][k] > 0, f"durable path: {k} never launched")
        check(dur["concurrent"]["launches"][k] > 0,
              f"concurrent readers' path: {k} never launched")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ten = tenant_path(torch, dev)
    ten["seconds"] = time.perf_counter() - t0
    emit("tenant_path", **ten)
    for k in ("frontier_min", "hash_probe"):
        check(ten["lane_launches"][k] > 0,
              f"tenant path: {k}'s tenant-row form never launched")
    torch.cuda.empty_cache()

    bag_rep = bag_path(torch, dev)
    emit("embedding_bag_path", **bag_rep)
    check(bag_rep["launches"]["embedding_bag"] == bag_rep["calls"],
          "embedding_bag did not launch on every call of its path")
    torch.cuda.empty_cache()

    lm_rep = lm_path(torch, dev)
    emit("lm_main_path", **lm_rep)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    lm_cmp = lm_card_vs_cpu(torch, dev)
    emit("lm_card_vs_cpu", seconds=time.perf_counter() - t0, **lm_cmp)

    # hash_probe: the insert entry's launches, the form its entry times;
    # all three entries' launches stand beside them
    launches = {"frontier_min": main_rep["launches"]["frontier_min"],
                "hash_probe": main_rep["hash_probe_launches"]["insert"],
                "bool_matmul": dense_rep["launches"]["bool_matmul"],
                "flash_attention": lm_rep["launches"]["flash_attention"],
                "embedding_bag": bag_rep["launches"]["embedding_bag"]}
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name]["source"],
             replaces=KERNELS[name]["replaces"], launches=launches[name],
             max_abs_err=kern[name]["max_abs_err"], ms=kern[name]["ms"],
             host_ms=kern[name]["host_ms"], plain_ms=kern[name]["plain_ms"],
             bound_ms=kern[name]["bound_ms"],
             bound_by=kern[name]["bound_by"],
             library_ms=kern[name]["library_ms"],
             shape=kern[name]["shape"],
             **({"launches_by_entry": main_rep["hash_probe_launches"]}
                if name == "hash_probe" else {}),
             **({"lanes": dict(ten["kernels"][name],
                               launches=ten["lane_launches"][name])}
                if name in ten["kernels"] else {}))
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
