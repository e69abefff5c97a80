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
   band-sensitive shapes, flash also at the MoE archs' prefill layers,
   moonshot's 16 heads on 16 kv heads and qwen3-moe's 64 on 4; 1e-5 for
   the embedding bag, also at MIND's profile bag, and at its training
   shape forward and backward), with CUDA-event
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
   kernel) it replaced, each held to the other exactly; and every
   fixpoint form (``fixpoint_checks``: boolean, its cap at 3 rounds,
   FW/BW pair, labels with and without pointer doubling, priorities,
   packed Reachable, trim), on update_1m's graph and over 256 tenant
   lanes at the tenant path's class-A shape, one cooperative launch a
   fixpoint held exactly (state and rounds) to the per-round loop on the
   card, the plain version on the card and on CPU copies, with no host
   read, timed from a replayed CUDA graph beside the per-round loop and
   the plain version; and the scc form (``scc_rows``: the whole static
   SCC, outer loop included, in one launch; min labels and priorities)
   on the same graphs, held exactly (labels, outer rounds, rounds by
   form) to its plain version on the card and to one launch a sweep with
   a host read an outer round (the parent's path, ``loop_ms``); each
   fixpoint and scc row also carries its parts (``part_rows``: one
   launch with part stamps, each pass in microseconds, the edge list's
   making once a launch), a byte bound that reads each input once
   (``bound_ms``) and the rounds times one round's bytes beside it
   (``rounds_bound_ms``);
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
   launch counts are set to 0 just before and read just after (every
   frontier_min launch a fixpoint launch; the rounds they ran, by form,
   read once from the card's counter afterwards); the maintained labels
   must equal a fresh static recompute of the final graph;
   every step on the card is one replay of the step's CUDA graph, so
   phases 3 and 4 must make 0 host syncs a step, and update_1m's
   fixpoint rounds must stay 99.90625 (frontier) and 8.0625 (trim) a step;
4. dense tier: the same path, smaller, with dense_capacity=512, read the
   same way (reach_blockmm must launch);
4b. step graph (``step_graph_checks``), at update_1m's shape and at the
   dense tier's: the step's graph captured anew under sync debug "error",
   2 super-chunks of 4 buckets of the paper's mix through it equal to
   the eager per-decision step on the card (and, at the dense tier, the
   CPU's), state, ok, overflow and RepairStats, with no host read; one
   capture per (cfg, bucket); a state held as a reader holds a snapshot
   bit-identical after 4 more super-chunks;
5. card vs CPU: one seeded stream at 2^14 vertices and a 2^16-slot table
   through the port on the card and on the CPU (plain versions): per-op
   results, labels and edge sets must be identical;
6. embedding-bag path: MIND-shaped requests (2^21 x 64 f32 table, 512 bags
   of 50 ids, ~20% padding) in sum, weighted and mean modes through the
   wrapper, counted the same way;
7. LM main path: ``launch.serve.serve_lm`` with Qwen3-14B at full width and
   depth (40 layers, bf16, random weights from a seeded generator on the
   card, flash attention): 4 requests of 4096 prompt tokens, then 32
   greedy decode steps, twice on the same weights and prompts: the eager
   loop (every op issued from Python), then as the server decodes on a
   card, one replay of the captured decode step a token
   (``launch.serve.DecodeGraph``, captured once), its device time from
   CUDA events around the replays; the tokens must be identical, and
   both runs' tokens/s are reported; flash must launch once per layer of
   the prefill, on the [B,S,H,D] buffers as they lie (no layout copy);
   then the MoE archs the same way: moonshot-v1-16b-a3b at full width and
   depth (48 layers, 64 experts top-6 + 2 shared, bf16, 28552923136
   parameters) and qwen3-moe-235b-a22b at full width and 4 of its 94
   layers (``reduced`` says why), 4 x 4096 prompt tokens and 16 decode
   steps each, flash once per layer;
8. LM card vs CPU: the qwen3, danube, moonshot and qwen3-moe smoke
   configs in f32 (TF32 off), the same weights on both devices through
   ``carry``, prefill then decode teacher-forced with the CPU's greedy
   tokens: logits within 2e-4;
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
   the card (ops/s of both), labels a static recompute for a sample
   and for every class-A tenant; each wave a lane-graph replay per
   dispatch, class A's host syncs per wave at most 1.5 at T = 256 and at
   T = 8 (the flush's one transfer), the lane graphs captured within the
   engine's compile bound, the scc form's launches counted; 8 tenants
   on the card equal the CPU; ``serve_tenants`` plain and with a durable
   root (its stores open equal on the CPU); one chaos soak seed.  The
   tenant-row forms of frontier_min and hash_probe are held to their
   plain versions at class A's shape and timed;
11. baselines (after phase 10, ``baselines_path``): the paper's §7
   comparison at 2^14 vertices and 2^16 slots, one seeded preloaded graph
   and 256 ops of the paper's mix through ``dynamic.apply_batch`` (B =
   256), ``sequential_apply``, ``coarse_apply`` and
   ``static_per_batch_apply``: update ops/s of each, all four on one
   graph and labelling, each equal to a static recompute;
12. MIND (after phase 8, ``mind_path``): ``configs/mind.py``'s full
   config (2^21 x 64 item table, 8192 x 64 profile table) through
   ``serve_mind``: 8 serve_p99 requests (512 users x 2048 candidates,
   scores/s and per-request latency) and one retrieval_cand request (1
   user, 10^6 candidates, top 100), the profile bag's kernel once a
   request; then MIND's smoke config card vs CPU, scores within 1e-5;
13. LM training (after phase 12, ``train_lm_path``): qwen3-14b at full
   width (d 5120, 40 heads on 8, d_ff 17408, vocab 151936, qk-norm, bf16,
   random weights from a seeded generator on the card), depth cut 40 ->
   4 and batch to 2 x 4096 tokens (``reduced`` says why), chunked
   attention and remat ``full`` as the reference's train step sets them,
   6 steps of the port's Trainer (``launch.train``'s setup, the reference
   launcher's AdamW) on ``lm_batch`` streams: per-step loss, median step
   time, tokens/s, peak memory and ``model_flops_share`` (the reference's
   ``lm_model_flops`` over the median step and 989 TFLOP/s); every loss
   finite, every leaf's step-1 gradient nonzero, peak under 80 GB;
14. MIND training (``train_mind_path``): ``configs/mind.py``'s full config
   at its train_batch of 65536 users, 4 steps: users/s, the time to make
   a batch apart, peak memory; one bag launch a forward, a nonzero
   ``profile_embed`` gradient, finite losses;
15. training card vs CPU (``train_card_vs_cpu``): the qwen3 (chunked,
   remat full), moonshot (MoE, aux loss on) and MIND smoke configs in f32
   with TF32 off, one state on both devices through ``carry``: loss within
   1e-5 relative, every gradient leaf and every parameter after one
   Trainer step within 2e-4 (MIND's through the bag kernel's forward and
   its Function's backward);
16. resume (``train_resume_check``): a bf16 trainer state saved on the
   card, 3 steps, restored into a trainer built from other weights, the
   same 3 steps: final params bit-identical;
17. flash under a gradient (``flash_grad_refusal``): a loss through the
   flash kernel launches it once a layer and its backward raises;
18. GNN training (``train_gnn_path``, TF32 off): egnn (4 x 64), gatedgcn
   (16 x 70), nequip (5 x 32, l_max 2, 8 rbf) and mace (2 x 128, l_max 2,
   correlation 3) at their published configs, remat on as the
   reference's ``build_gnn`` sets it, the port's Trainer with the
   reference launcher's AdamW, on the reference's shapes
   (``configs/gnn_shapes.py``): molecule (128 graphs x 30 nodes x 64
   edges, energy and forces: a second derivative through every scatter
   and checkpointed layer; gatedgcn energy only), full_graph_sm (Cora's
   size) and minibatch_lg (a Reddit-sized CSR of ~1.146e8 edges and a
   232965 x 602 feature table on the card, 1024 seeds sampled at fanouts
   15, 10 a step), 4 steps each; and nequip alone on ogb_products
   (2449029 nodes, 61859140 edges + 60 masked) with its chunked-edge
   convolution in ``launch.steps.build_gnn``'s 32 chunks, 2 steps, in a
   child process with the allocator's expandable segments on for that
   cell alone, its reserve held under 80 GB (``reduced`` gives the
   padding and the memory reckoning that keeps the other three off one
   card).  One
   ``train_gnn`` line a run: median step time, graphs/s, nodes/s or
   seeds/s, the batch's making (sampling included) apart, peak memory
   allocated and reserved, ``model_flops_share`` (the reference's
   ``gnn_model_flops`` over the median step and 67 TFLOP/s); every loss
   and force finite, step 1's zero gradients exactly the leaves the
   reference's loss leaves zero, the allocator's peak reserve under
   80 GB;
19. GNN card vs CPU (``gnn_card_vs_cpu``): each arch's smoke config on
   both tasks, one state on both devices through ``carry``: loss and
   energies within 1e-5 relative, logits, forces, gradients and the
   params after one Trainer step within rtol 2e-4 / atol 2e-5 (f32, TF32
   off; MACE's energy task in f64, which its conditioning needs); NequIP
   chunked against unchunked on the card (rtol 1e-5 / atol 1e-6
   energies, rtol 2e-3 / atol 1e-5 first-order gradients); the sampler
   on the card equal to the CPU's given the same draws;
20. the launch layer (``bundle_path``): ``launch.steps.build``'s bundles
   on ``make_host_mesh()`` (one card, a 1x1 mesh) at the configs' own
   shapes: smscc:update_1m (2^20 vertices, 2^23 slots, batches of 8192)
   and smscc:update_16m (2^24 vertices, 2^26 slots, batches of 65536),
   each booted with update_1m's out-degree-2 preload and 4 batches of
   the paper's mix, then smscc:community_query (262144 pairs) and
   mind:serve_p99 (512 x 2048 candidates on the 2^21-row table): each
   result equal to the port's function called directly on the same
   inputs (the bundle's plumbing), the SMSCC labels a static recompute,
   one MIND request the scores through the bag's plain version (1e-5),
   frontier_min, hash_probe and embedding_bag launched; step time, ops/s and peak memory; then
   ``reach_blockmm.frontier_step`` / ``closure`` on the card against
   their plain forms exactly (one bool_matmul launch a product), and one
   dry-run cell (smscc:update_1m on 16x16) in a child process with its
   own fake process group of 256 ranks, its record printed;
21. the kernels line (JSON; frontier_min's entry is the boolean fixpoint
   launch at update_1m, with every fixpoint row (the scc form's among
   them), the main path's fixpoint launches and rounds under ``fixpoint``
   and the round kernel alone under ``round``; frontier_min and
   hash_probe also carry their tenant-row form under ``lanes``; flash
   and the bag their launches on each path under ``launches_by_path``,
   flash its MoE-shape rows under
   ``moe_shapes``, the bag its training-shape row, forward and backward,
   under ``train_shape``), the card line, and the device line last.

Any failed check exits non-zero.  Without a CUDA card it exits 1 before
printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import math
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
# serve_path's cells: update_1m (phase 3, the main path) and the dense
# tier (phase 4)
SERVE_CELLS = {
    "update_1m": dict(nv=2 ** 20, cap=2 ** 23, bucket=8192, chunk=4 * 8192,
                      n_chunks=8, preload_deg=2),
    "dense_tier": dict(nv=2 ** 14, cap=2 ** 16, bucket=256, chunk=1024,
                       n_chunks=8, preload_deg=0, dense_capacity=512,
                       n_same=256),
}

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


def timed(torch, fn):
    """(fn(), ms of that one call on CUDA events): for calls that read
    the host as they go, so a graph cannot hold them."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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


def read_once_ms(slots: int, words: int, state_bytes: int) -> tuple:
    """A fixpoint's bound, each input read once and each output written
    once, whatever the rounds: the table (src, dst 4 B, live 1 B a slot),
    the mask (1 B a vertex and lane) and the state read and written
    (``state_bytes`` each way).  ``bound_ms``' (ms, by)."""
    return bound_ms(9 * slots + words + 2 * state_bytes)


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
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fix = fixpoint_checks(torch, dev, g)
    emit("frontier_fixpoints", tolerance="exact",
         seconds=time.perf_counter() - t0, rows=fix)
    # the main path's own form: one launch of the boolean fixpoint at
    # update_1m (its rounds' kernel alone under "round")
    out["frontier_min"] = dict(fix["update_1m"][0], round=rounds[0],
                               fixpoints=fix)

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


def _fix_cases(torch, dev, g, allowed, vid, cap):
    """(tag, form, shortcut, mask, init, max_iters) of every fixpoint form
    on one graph (or [T, NV] lanes): 8192 random seeds a graph (one update
    bucket), the recompute's labels, a Reachable batch of 32 single
    sources, trim's peel from every vertex; the boolean form again at a
    cap of 3 rounds."""
    from repro_torch.kernels.frontier_expand import ref as fref

    nv = allowed.shape[-1]
    lead = allowed.shape[:-1]

    def some(n):
        m = torch.zeros(allowed.shape, dtype=torch.bool, device=dev)
        m.view(-1, nv).scatter_(1, torch.randint(
            0, nv, (m.view(-1, nv).shape[0], n), generator=g, device=dev),
            True)
        return m & allowed

    single = torch.zeros((*lead, 32, nv), dtype=torch.bool, device=dev)
    single.view(-1, nv).scatter_(1, torch.randint(
        0, nv, (single.view(-1, nv).shape[0], 1), generator=g, device=dev),
        True)
    packed = torch.stack([fref.pack_bits(q) for q in
                          single.view(-1, 32, nv)]).view(*lead, 1, nv)
    seeds = min(8192, nv // 16)
    labels = torch.where(allowed, vid, 2 ** 31 - 1)
    return (
        ("boolean", "reach", False, allowed, some(seeds), cap),
        ("boolean, cap 3", "reach", False, allowed, some(seeds), 3),
        ("fw/bw pair", "pair", False, allowed,
         torch.stack([some(seeds), some(seeds)], dim=-2), cap),
        ("labels", "label", False, allowed, labels, cap),
        ("labels, shortcut", "label", True, allowed, labels, cap),
        ("priorities", "prio", False, allowed,
         torch.where(allowed, fref.prio(vid), fref.PRIO_SENT), cap),
        ("packed Reachable Q=32", "or", False, allowed, packed & -allowed
         .int().unsqueeze(-2), cap),
        ("trim", "trim", False, None,
         (allowed, torch.full(allowed.shape, 2 ** 31 - 1, dtype=torch.int32,
                              device=dev)), cap))


def part_rows(torch, kern, want, where, tag) -> dict:
    """A fixpoint row's parts: one launch of ``kern(stamps=...)`` with part
    stamps (``ops.fixpoint_parts``), its result equal to ``want``.  The
    launch's grid and blocks an SM (grid / SMs), the sweeps' rounds the
    card counted, and each pass in microseconds with its barrier wait: a
    pass's mean over the barriers of its kind, the edge lists' making in
    total a launch."""
    from repro_torch.kernels.frontier_expand import ops as fops

    def same(a, b):
        if isinstance(a, tuple):
            return all(same(x, y) for x, y in zip(a, b))
        return torch.equal(a, b)

    dev = want[1].device
    fops.reset_fixpoint_rounds()
    buf = fops.stamp_buffer(dev)
    got = kern(stamps=buf)
    swept = sum(n for k, n in fops.fixpoint_rounds().items() if k != "scc")
    check(same(got, want), f"{tag} on {where}: a stamped launch differs")
    stamped = fops.fixpoint_parts(buf)
    parts = {k: round((p["pass_us"] + p["wait_us"]) /
                      (1 if k == "compact" else max(p["n"], 1)), 3)
             for k, p in stamped["parts"].items()
             if k in ("edge", "vertex", "hop", "compact")}
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else 1)
    return dict(grid=stamped["grid"], blocks_an_sm=stamped["grid"] / sms,
                swept_rounds=swept, parts_us_a_round=parts)


def fixpoint_graphs(torch, dev, nv=2 ** 20, cap=2 ** 23, lanes=256,
                    lane_nv=4096, lane_cap=2 ** 14) -> tuple:
    """(where, state) of the fixpoint rows' two graphs: update_1m's
    preloaded graph (``nv`` vertices, ``cap`` slots, out-degree 2 from a
    seeded generator) and ``lanes`` tenant lanes at the tenant path's
    class-A shape, booted by a lane recompute."""
    import numpy as np

    from repro_torch.configs import smscc
    from repro_torch.core import graph_state as gs

    rng = np.random.default_rng(SEED)
    src_np = np.repeat(np.arange(nv, dtype=np.int32), 2)
    state = gs.from_arrays(smscc.config(n_vertices=nv, edge_capacity=cap),
                           src_np, rng.integers(0, nv, src_np.shape[0])
                           .astype(np.int32), device=dev)
    lcfg = smscc.config(n_vertices=lane_nv, edge_capacity=lane_cap)
    boot, _, _ = boot_lanes(torch, dev, lcfg, lanes, 2, SEED + 40)
    return ("update_1m", state), (f"lanes T={lanes}", boot)


def fixpoint_checks(torch, dev, g, nv=2 ** 20, cap=2 ** 23, lanes=256,
                    lane_nv=4096, lane_cap=2 ** 14, reps=3) -> dict:
    """Every fixpoint form of frontier_min (``ops.frontier_fixpoint``: all
    rounds of one sweep in one cooperative launch, no host read) on
    update_1m's preloaded graph (2^20 vertices, 2^23 slots, 2^21 live edges
    of out-degree 2) at ``max_inner`` (256) and at a cap of 3, and over
    ``lanes`` tenant lanes at the tenant path's class-A shape (4096
    vertices, 2^14 slots, out-degree 2, booted by a lane recompute).  Each
    launch is held exactly, state and rounds, to the per-round loop on the
    card (``reach.round_loop``: the parent's path, one frontier_gather
    launch and one host read a round), to the plain version on the card
    and on CPU copies (all forms but the packed OR, ``held_to``), and
    must make no host read.  Times: ``ms`` the launch's device time from
    a replayed CUDA graph (so it captures), ``host_ms`` the wrapper back
    to back, ``loop_ms`` the per-round loop and ``plain_ms`` the plain
    version on the card, one call each; ``bound_ms`` every input read once
    and the state written once (``read_once_ms``), and
    ``rounds_bound_ms`` the rounds times one round's bytes as
    ``frontier_round_checks`` reckons them (src, dst 4 B and live 1 B a
    slot, val and out 4 B a vertex and row), the bound PERF.md kept for
    the fixpoint forms before the edge list.  Each row adds
    ``part_rows``."""
    from repro_torch.configs import smscc
    from repro_torch.core import reach
    from repro_torch.core.edge_table import LIVE
    from repro_torch.core.sync import SYNCS
    from repro_torch.kernels.frontier_expand import ops as fops
    from repro_torch.kernels.frontier_expand import ref as fref

    max_inner = smscc.config().max_inner
    out = {}
    for where, st in fixpoint_graphs(torch, dev, nv, cap, lanes, lane_nv,
                                     lane_cap):
        src, dst, live = st.edges.src, st.edges.dst, st.edges.state == LIVE
        allowed = st.v_alive
        n = allowed.shape[-1]
        vid = torch.arange(n, dtype=torch.int32, device=dev)
        cpu = [x.cpu() for x in (src, dst, live)]
        rows = []
        for tag, form, shortcut, mask, init, it in _fix_cases(
                torch, dev, g, allowed, vid, max_inner):
            kw = dict(shortcut=shortcut, vid=vid)

            def kern(i=init, m=mask, f=form, k=kw, c=it, **probe):
                return fops.frontier_fixpoint(f, src, dst, live, m, i, c,
                                              **k, **probe)

            def loop(i=init, m=mask, f=form, k=kw, c=it):
                return reach.round_loop(f, src, dst, live, m, i, c, **k)

            def plain(i=init, m=mask, f=form, k=kw, c=it):
                return fref.frontier_fixpoint(f, src, dst, live, m, i, c,
                                              **k)

            s0 = SYNCS.count
            got = kern()
            check(SYNCS.count == s0, f"fixpoint {tag}: a host read")
            want, loop_ms = timed(torch, loop)
            ref_card, plain_ms = timed(torch, plain)
            runs = {"loop": want, "plain": ref_card}
            # the CPU's packed-OR rounds unpack 32 frontiers of int64
            # messages per slot (~6 s a round at 2^23 slots); the card's
            # plain version and the gpu tests (at small sizes) hold it
            if form != "or":
                runs["cpu"] = fref.frontier_fixpoint(
                    form, *cpu, None if mask is None else mask.cpu(),
                    tuple(x.cpu() for x in init) if form == "trim" else
                    init.cpu(), it, shortcut=shortcut, vid=vid.cpu())
            mine = got[0] if form == "trim" else (got[0],)
            for name, (st_, n_) in runs.items():
                theirs = st_ if form == "trim" else (st_,)
                check(all(torch.equal(a.cpu(), b.cpu()) for a, b in
                          zip(mine, theirs)) and
                      torch.equal(got[1].cpu(), n_.cpu()),
                      f"fixpoint {tag} on {where} differs from the "
                      f"{name} version")
            rounds = got[1].tolist()
            ran = max(rounds) if isinstance(rounds, list) else rounds
            f_rows = 1 if form == "trim" else (
                init.shape[-2] if form in ("pair", "or") else 1)
            t_n = src.numel() // src.shape[-1]
            b_ms, b_by = read_once_ms(src.numel(), n * t_n, sum(
                x.numel() * x.element_size()
                for x in (init if form == "trim" else (init,))))
            r_ms, _ = bound_ms(ran * (9 * src.numel()
                                      + 2 * 4 * f_rows * n * t_n))
            theirs = ref_card[0] if form == "trim" else (ref_card[0],)
            rows.append(checked_row(dict(
                shape=f"{tag}: E={src.shape[-1]} NV={n}"
                      + (f" x T={t_n}" if t_n > 1 else "")
                      + f", max_iters {it}",
                form=form, shortcut=shortcut, rounds=rounds,
                held_to=sorted(runs),
                max_abs_err=max(max_abs_err(torch, a, b) for a, b in
                                zip(mine, theirs)),
                ms=graph_ms(torch, kern, reps),
                host_ms=cuda_ms(torch, kern, reps), loop_ms=loop_ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by, rounds_bound_ms=r_ms,
                **part_rows(torch, kern, got, where, tag))))
            del got, want, ref_card, runs
        rows += scc_rows(torch, dev, src, dst, live, allowed, where, reps)
        out[where] = rows
        torch.cuda.empty_cache()
    return out


def scc_rows(torch, dev, src, dst, live, active, where, reps) -> list:
    """The scc form (the whole static SCC of ``active``, its outer loop
    included, in one launch) at the config's caps, min labels and
    priorities: held exactly (labels, each lane's outer rounds, the rounds
    by form on the card's counter) to its plain version on the card
    (``ref.scc_loop`` over the plain fixpoints; the CPU tests hold it to
    JAX) and to the parent's path (``scc_loop`` over one fixpoint launch a
    sweep and one host read an outer round: ``loop_ms``); no host read.
    Bound: read once, the table, the active set and the labels written;
    beside it the rounds its sweeps ran times one round's bytes, as
    ``fixpoint_checks`` reckons them.  Each row adds ``part_rows``."""
    from repro_torch.configs import smscc
    from repro_torch.core import reach
    from repro_torch.core.sync import SYNCS
    from repro_torch.kernels.frontier_expand import ops as fops
    from repro_torch.kernels.frontier_expand import ref as fref

    cfg = smscc.config()
    max_outer, max_inner = cfg.max_outer, cfg.max_inner
    n = active.shape[-1]
    t_n = src.numel() // src.shape[-1]
    rows = []
    for shortcut in (False, True):
        def kern(sc=shortcut, **probe):
            return fops.frontier_fixpoint("scc", src, dst, live, active, None,
                                          max_inner, shortcut=sc,
                                          max_outer=max_outer, **probe)

        def loop(sc=shortcut):
            return fref.scc_loop(src, dst, live, active, max_outer,
                                 max_inner, shortcut=sc, fix=reach._fix,
                                 read=SYNCS.bool)

        tally = {}

        def plain(sc=shortcut, x=(src, dst, live, active)):
            return fref.scc_loop(*x, max_outer, max_inner, shortcut=sc,
                                 tally=tally)

        fops.reset_fixpoint_rounds()
        s0 = SYNCS.count
        got = kern()
        check(SYNCS.count == s0, f"scc form on {where}: a host read")
        by_form = {k: n_ for k, n_ in fops.fixpoint_rounds().items() if n_}
        want, plain_ms = timed(torch, plain)
        runs = {"plain": want, "loop": None}
        runs["loop"], loop_ms = timed(torch, loop)
        tag = "scc" + (", shortcut" if shortcut else "")
        for name, (lab, outer) in runs.items():
            check(torch.equal(got[0].cpu(), lab.cpu()) and
                  torch.equal(got[1].cpu(), outer.cpu()),
                  f"{tag} on {where} differs from the {name} version")
        check(by_form == {k: n_ for k, n_ in tally.items() if n_},
              f"{tag} on {where}: rounds by form {by_form} != {tally}")
        swept = sum(tally.get(k, 0) for k in ("trim", "label", "prio"))
        # the active set read, the labels written
        b_ms, b_by = read_once_ms(src.numel(), n * t_n, 2 * n * t_n)
        r_ms, _ = bound_ms(swept * (9 * src.numel() + 2 * 4 * n * t_n))
        rows.append(checked_row(dict(
            shape=f"{tag}: E={src.shape[-1]} NV={n}"
                  + (f" x T={t_n}" if t_n > 1 else "")
                  + f", max_outer {max_outer}, max_iters {max_inner}",
            form="scc", shortcut=shortcut, rounds=got[1].tolist(),
            rounds_by_form=tally, held_to=sorted(runs),
            max_abs_err=max_abs_err(torch, got[0], want[0]),
            ms=graph_ms(torch, kern, reps), host_ms=cuda_ms(torch, kern, reps),
            loop_ms=loop_ms, plain_ms=plain_ms, library_ms=None,
            bound_ms=b_ms, bound_by=b_by, rounds_bound_ms=r_ms,
            **part_rows(torch, kern, got, where, tag))))
        del got, want, runs
    return rows


def step_graph_checks(torch, dev, cell, *, n_super=2, k=4, cpu=False
                      ) -> dict:
    """The update step as one replay of its captured CUDA graph
    (``dynamic.apply_batch_scan`` on the card, captured here anew under
    ``torch.cuda.set_sync_debug_mode("error")``, so any read back inside
    it raises) against the eager per-decision step on the card
    (``apply_batch_stats_eager``: the gate and the region sizes read back)
    and, with ``cpu``, the CPU's step: state, ok, overflow and RepairStats
    exactly, over ``n_super`` super-chunks of ``k`` buckets of the cell's
    own batches (``launch.workload.op_stream``, the paper's mix) from its
    booted graph; no SYNCS tick in the graph's steps.  Then a state held
    as a reader holds a snapshot must be bit-identical after 4 more
    super-chunks through the same graph.  Times: a super-chunk through the
    graph and through the eager steps (CUDA events, one call each)."""
    import numpy as np

    from repro_torch.configs import smscc
    from repro_torch.core import dynamic, step_graph
    from repro_torch.core.sync import SYNCS
    from repro_torch.launch import workload
    from repro_torch.tree import tree_leaves

    c = SERVE_CELLS[cell]
    cfg = smscc.config(n_vertices=c["nv"], edge_capacity=c["cap"],
                       dense_capacity=c.get("dense_capacity", 0))
    b = c["bucket"]
    boot, _ = boot_state(torch, dev, cfg, c["preload_deg"])

    def chunk(i):
        parts = [workload.op_stream(cfg.n_vertices, b, step=k * i + j,
                                    add_frac=0.7, seed=SEED + 7)
                 for j in range(k)]
        return dynamic.OpBatch(*(torch.stack(x) for x in zip(*parts)))

    def same(a, b_):
        return all(torch.equal(x.cpu(), y.cpu())
                   for x, y in zip(tree_leaves(a), tree_leaves(b_)))

    step_graph.clear()
    before = step_graph.stats()
    step_graph.SYNC_DEBUG = True
    rep = {"cell": cell, "bucket": b, "super_chunks": n_super, "k": k,
           "tiers": {}, "graph_ms": [], "eager_ms": []}
    st = {"graph": boot, "eager": boot}
    if cpu:
        st["cpu"] = boot_state(torch, torch.device("cpu"), cfg,
                               c["preload_deg"])[0]
    syncs = 0
    try:
        for i in range(n_super):
            ops = chunk(i)
            s0 = SYNCS.count
            g, g_ms = timed(torch, lambda: dynamic.apply_batch_scan(
                st["graph"], ops, cfg))
            syncs += SYNCS.count - s0
            rep["graph_ms"].append(g_ms)

            def eager(d, state):
                outs = []
                for j in range(k):
                    state, *o = dynamic.apply_batch_stats_eager(
                        state, dynamic.OpBatch(*(x[j] for x in ops)), cfg)
                    outs.append(o)
                ok, ovf, stats = zip(*outs)
                return (state, torch.stack(ok), torch.stack(ovf),
                        dynamic.RepairStats(*(torch.stack(x)
                                              for x in zip(*stats))))
            e, e_ms = timed(torch, lambda: eager(dev, st["eager"]))
            rep["eager_ms"].append(e_ms)
            outs = {"eager": e}
            if cpu:
                outs["cpu"] = dynamic.apply_batch_scan(st["cpu"], ops, cfg)
            for name, o in outs.items():
                check(same(g[0], o[0]) and torch.equal(g[1].cpu(), o[1].cpu())
                      and torch.equal(g[2].cpu(), o[2].cpu()) and
                      all(torch.equal(x.cpu(), y.cpu())
                          for x, y in zip(g[3], o[3])),
                      f"step graph on {cell}: super-chunk {i} differs from "
                      f"the {name} step")
                st[name] = o[0]
            st["graph"] = g[0]
            for t in g[3].tier.tolist():
                name = dynamic.TIER_NAMES[t]
                rep["tiers"][name] = rep["tiers"].get(name, 0) + 1
        check(syncs == 0, f"step graph on {cell}: {syncs} host reads")
        held = st["graph"]
        copy = [x.cpu().clone() for x in tree_leaves(held)]
        cur = held
        for i in range(n_super, n_super + 4):
            cur = dynamic.apply_batch_scan(cur, chunk(i), cfg)[0]
        sync(torch, dev)
        check(all(torch.equal(a.cpu(), b_) for a, b_ in
                  zip(tree_leaves(held), copy)),
              f"step graph on {cell}: a held snapshot was rewritten")
    finally:
        step_graph.SYNC_DEBUG = False
    after = step_graph.stats()
    rep.update(host_syncs=syncs, snapshot_kept=True,
               captures=after["step_graph_captures"]
               - before["step_graph_captures"],
               capture_s=after["capture_s"] - before["capture_s"],
               held_to=sorted(outs), tiers_by_step=rep.pop("tiers"))
    check(rep["captures"] == 1, f"step graph on {cell}: {rep['captures']} "
          "captures for one (cfg, bucket)")
    del st, held, cur
    step_graph.clear()
    return rep


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
            ("moonshot-v1-16b-a3b prefill layer", 4, 16, 16, 4096, 128, 0,
             torch.bfloat16, 3e-2, 10),
            ("qwen3-moe-235b-a22b prefill layer", 4, 64, 4, 4096, 128, 0,
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
    out["flash_attention_moe"] = rows[1:3]
    emit("flash_band_checks", rows=flash_band_checks(torch, aops, aref, g,
                                                     dev))

    # embedding_bag: MIND's item table (2^21 x 64 f32) and serve_p99 bags
    # (512 x 50), ~20% padding, in sum, weighted sum and mean; then MIND's
    # profile bag as its serving path calls it: the 8192 x 64 profile
    # table, 512 bags of 8 ids drawn from [-1, 8192) (serve_mind's draw),
    # mean
    item_table, item_ids = mind_table(torch, dev, g), mind_ids(torch, dev, g)
    wts = torch.rand(item_ids.shape, generator=g, device=dev)
    prof_table = torch.randn((8192, 64), generator=g, device=dev)
    prof_ids = torch.randint(-1, 8192, (512, 8), generator=g, device=dev,
                             dtype=torch.int32)
    rows = []
    for table, ids, mode, weights in (
            (item_table, item_ids, "sum", None),
            (item_table, item_ids, "sum", wts),
            (item_table, item_ids, "mean", None),
            (prof_table, prof_ids, "mean", None)):
        valid = (ids >= 0) & (ids < table.shape[0])
        nnz = int(valid.sum())
        safe_ids = torch.where(valid, ids, torch.zeros_like(ids))
        n_ids = (ids >= 0).sum(1, keepdim=True).clamp_min(1).float()
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
    out["embedding_bag_train"] = bag_train_row(torch, dev, g, eops, eref)
    rows.append(out["embedding_bag_train"])
    emit("kernel", name="embedding_bag", rows=rows)
    out["embedding_bag"] = rows[3]  # the MIND serving path's bag
    return out


def bag_train_row(torch, dev, g, eops, eref) -> dict:
    """MIND's profile bag at its training shape (train_batch 65536 users x
    profile_len 8 ids drawn from the 8192 x 64 table, mean, no padding:
    ``mind_batch``'s draw): the kernel's forward and the Function's backward
    (plain torch) against autograd through the plain version, 1e-5; device
    and host ms of each, their byte bounds (each input read once: the rows
    the ids name, once each; the dense table gradient written once), and
    the plain version's and ``F.embedding_bag``'s forward + backward."""
    import torch.nn.functional as F

    v, d, b, l = 8192, 64, 65536, 8
    table = torch.randn((v, d), generator=g, device=dev)
    ids = torch.randint(0, v, (b, l), generator=g, device=dev,
                        dtype=torch.int32)
    grad = torch.randn((b, d), generator=g, device=dev)
    leaf = table.clone().requires_grad_()
    ids64 = ids.long()

    def fwd():
        return eops.embedding_bag(table, ids, mode="mean")

    def bwd():
        return eops.backward(table, ids, "mean", None, grad)

    def grad_of(bag):
        return torch.autograd.grad(bag(leaf), [leaf], grad)[0]

    port = lambda t: eops.embedding_bag(t, ids, mode="mean")  # noqa: E731
    plain = lambda t: eref.embedding_bag(t, ids, mode="mean")  # noqa: E731
    lib = lambda t: F.embedding_bag(ids64, t, mode="mean")  # noqa: E731
    got, want = fwd(), eref.embedding_bag(table, ids, mode="mean")
    d_got, d_want = grad_of(port), grad_of(plain)
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
          "embedding_bag at MIND's training shape disagrees")
    check(torch.allclose(d_got, d_want, rtol=1e-5, atol=1e-5),
          "embedding_bag's backward disagrees with autograd of the plain "
          "version")
    rows_read = int(torch.unique(ids).numel())
    b_ms, b_by = bound_ms(ids.numel() * 4 + rows_read * d * 4 + b * d * 4)
    bb_ms, bb_by = bound_ms(b * d * 4 + ids.numel() * 4 + v * d * 4)
    row = dict(
        shape=f"train mean: V={v} D={d} B={b} L={l} nnz={ids.numel()} "
              f"rows_read={rows_read}",
        tolerance=1e-5, max_abs_err=float((got - want).abs().max()),
        backward_max_abs_err=float((d_got - d_want).abs().max()),
        ms=graph_ms(torch, fwd, 20), host_ms=cuda_ms(torch, fwd, 20),
        plain_ms=cuda_ms(torch, lambda: plain(table), 20),
        library_ms=graph_ms(torch, lambda: lib(table), 20),
        bound_ms=b_ms, bound_by=b_by,
        backward_ms=graph_ms(torch, bwd, 20),
        backward_host_ms=cuda_ms(torch, bwd, 20),
        backward_bound_ms=bb_ms, backward_bound_by=bb_by,
        fwd_bwd_host_ms=cuda_ms(torch, lambda: grad_of(port), 20),
        plain_fwd_bwd_ms=cuda_ms(torch, lambda: grad_of(plain), 20),
        library_fwd_bwd_ms=cuda_ms(torch, lambda: grad_of(lib), 20))
    check(row["backward_ms"] >= bb_ms,
          f"{row['shape']}: backward {row['backward_ms']} ms is below its "
          f"bound")
    return checked_row(row)


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
    from repro_torch.core import dynamic, step_graph
    from repro_torch.core.service import SCCService
    from repro_torch.kernels.frontier_expand import ops as fops
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
    graphs = step_graph.stats()
    run = stream.run_stream(svc, n_chunks * chunk, add_frac=0.7,
                            query_frac=1.0, chunk=chunk, n_queries=n_same,
                            seed=SEED, budget_s=budget_s, record=record)
    rep["launches"] = kernels.launch_counts()
    # the step's CUDA graphs captured in the run (one per cfg and bucket,
    # the reference's compiles) and the seconds they took
    rep["step_graph"] = {k: step_graph.stats()[k] - graphs[k]
                         for k in ("step_graph_captures", "capture_s")}
    rep["hash_probe_launches"] = {e: getattr(hops, e).launches
                                  for e in ("probe", "insert", "remove")}
    rep["fixpoint_launches"] = fops.frontier_min.fixpoint_launches
    # rounds the fixpoint launches ran, added up on the card (read once,
    # after the run): updates run reach / pair / label / prio and trim,
    # the Reachable queries the packed OR
    rep["fixpoint_rounds"] = fops.fixpoint_rounds()
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
        frontier_rounds_per_step=sum(
            rep["fixpoint_rounds"][k] for k in
            ("reach", "pair", "label", "prio")) / max(steps, 1),
        trim_rounds_per_step=rep["fixpoint_rounds"]["trim"] / max(steps, 1),
        query_rounds=rep["fixpoint_rounds"]["or"],
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


def lm_path(torch, dev, cfg, *, batch=4, prompt=4096, steps=32,
            reduced=None) -> dict:
    """``cfg`` through ``serve_lm`` twice on the same weights and prompts:
    ``batch`` requests of ``prompt`` tokens, then ``steps`` greedy decode
    steps, first issued eagerly from Python (the path the graph is held
    to), then as the server runs them on a card: one replay of the
    captured decode step a token (the report's main fields; the eager
    run's under ``eager``).  The tokens must be identical and the graph
    captured once.  Flash must launch once per layer of the prefill, on
    the [B,S,H,D] buffers as they lie; the launch counts are the graph
    run's."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.launch import serve

    kw = dict(batch=batch, prompt_len=prompt, cache_len=prompt + steps,
              device=str(dev), seed=SEED)
    eager = serve.serve_lm(cfg, steps, decode="eager", **kw)
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    copies = aops.mha.layout_copies
    captures = serve.decode_captures
    rep = serve.serve_lm(cfg, steps, decode="graph", **kw)
    rep["launches"] = kernels.launch_counts()
    rep["flash_layout_copies"] = aops.mha.layout_copies - copies
    rep["decode_captures"] = serve.decode_captures - captures
    rep["eager"] = {k: eager[k] for k in (
        "prefill_s", "decode_s", "decode_tok_per_s",
        "host_s_per_decode_step", "peak_mem_bytes")}
    rep["graph_vs_eager_decode"] = (rep["decode_tok_per_s"]
                                    / eager["decode_tok_per_s"])
    if cfg.moe is not None:
        rep["n_active_params"] = cfg.n_active_params()
        rep["moe"] = {k: getattr(cfg.moe, k) for k in (
            "n_experts", "top_k", "d_ff", "n_shared_experts",
            "capacity_factor", "dispatch", "n_groups")}
    if reduced:
        rep["reduced"] = reduced
    tokens = rep.pop("tokens")
    rep["tokens_row0"] = tokens[0]
    check(tokens == eager["tokens"], f"{cfg.name}: the decode graph's "
                                     f"tokens differ from the eager loop's")
    check(rep["decode_captures"] == 1,
          f"{cfg.name}: {rep['decode_captures']} decode captures")
    check(rep["logits_finite"] and eager["logits_finite"],
          f"{cfg.name}: logits are not finite")
    check(len(tokens) == batch and all(
        len(t) == steps and all(0 <= x < cfg.vocab for x in t)
        for t in tokens), f"{cfg.name}: tokens out of range")
    check(rep["launches"]["flash_attention"] == cfg.n_layers,
          f"{cfg.name}: flash launched {rep['launches']['flash_attention']} "
          f"times, expected one per layer ({cfg.n_layers})")
    check(rep["flash_layout_copies"] == 0,
          f"{cfg.name}: the prefill copied {rep['flash_layout_copies']} "
          f"tensors for TMA")
    return rep


def lm_card_vs_cpu(torch, dev) -> dict:
    """The qwen3, danube, moonshot and qwen3-moe smoke configs in f32, one
    set of weights on both devices through ``carry``; prefill, then decode
    teacher-forced with the CPU's greedy tokens.  Logits must agree within
    2e-4."""
    import numpy as np

    from repro_torch import carry
    from repro_torch.configs import (h2o_danube_3_4b, moonshot_v1_16b_a3b,
                                     qwen3_14b, qwen3_moe_235b_a22b)
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.models import transformer as tf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch, prompt, steps, tol = 4, 40, 8, 2e-4  # prompt > danube's window
    out = {}
    for mod in (qwen3_14b, h2o_danube_3_4b, moonshot_v1_16b_a3b,
                qwen3_moe_235b_a22b):
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


def mind_path(torch, dev, p99_requests=8) -> dict:
    """MIND at ``configs/mind.py``'s full config through ``serve_mind``:
    ``p99_requests`` serve_p99 requests (512 users x 2048 candidates), then
    one retrieval_cand request (1 user, 10^6 candidates, top 100), each
    counted from 0: the profile bag's kernel must launch once a request."""
    from repro_torch import kernels
    from repro_torch.configs import mind
    from repro_torch.launch import serve

    cfg = mind.config()
    out = {"n_items": cfg.n_items, "embed_dim": cfg.embed_dim,
           "profile_vocab": cfg.profile_vocab,
           "profile_len": cfg.profile_len, "seq_len": cfg.seq_len}
    for tag, n, kw in (
            ("serve_p99", p99_requests, mind.SHAPES["serve_p99"]),
            ("retrieval_cand", 1, dict(mind.SHAPES["retrieval_cand"],
                                       top_k=100))):
        kernels.reset_launch_counts()
        rep = serve.serve_mind(cfg, n, batch=kw["batch"], n_cand=kw["n_cand"],
                               top_k=kw.get("top_k", 0), device=str(dev),
                               seed=SEED)
        rep["launches"] = kernels.launch_counts()
        last = rep.pop("last")
        check(rep["scores_finite"], f"MIND {tag}: scores are not finite")
        check(rep["launches"]["embedding_bag"] == n,
              f"MIND {tag}: the bag launched "
              f"{rep['launches']['embedding_bag']} times for {n} requests")
        if tag == "serve_p99":
            check(tuple(last.shape) == (kw["batch"], kw["n_cand"]),
                  f"MIND {tag}: scores shaped {tuple(last.shape)}")
        else:
            vals, idx = last
            check(tuple(idx.shape) == (1, 100)
                  and bool((vals[:, :-1] >= vals[:, 1:]).all())
                  and int(idx.min()) >= 0 and int(idx.max()) < kw["n_cand"],
                  f"MIND {tag}: top-100 out of order or out of range")
            rep["top5"] = vals[0, :5].tolist()
        out[tag] = rep
    return out


def mind_card_vs_cpu(torch, dev) -> dict:
    """MIND's smoke config, one set of weights on both devices through
    ``carry``, one batch of 32 users x 512 candidates: scores within
    1e-5; the top-100 indices are compared and reported."""
    import numpy as np

    from repro_torch import carry
    from repro_torch.configs import mind as mind_cfg
    from repro_torch.kernels.embedding_bag import ops as eops
    from repro_torch.models.recsys import mind

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, tol = mind_cfg.smoke_config(), 1e-5
    tree = carry.mind_params_to_numpy(
        mind.init(cfg, torch.Generator().manual_seed(SEED), "cpu"))
    rng = np.random.default_rng(SEED)
    batch = {"behavior": rng.integers(-1, cfg.n_items, (32, cfg.seq_len)),
             "profile": rng.integers(-1, cfg.profile_vocab,
                                     (32, cfg.profile_len)),
             "candidates": rng.integers(0, cfg.n_items, (32, 512))}
    runs = []
    for d in (torch.device("cpu"), dev):
        params = carry.mind_params_from_numpy(tree, cfg, d)
        b = {k: torch.from_numpy(v.astype(np.int32)).to(d)
             for k, v in batch.items()}
        before = eops.embedding_bag.launches
        scores = mind.serve_score(params, b, cfg)
        vals, idx = mind.retrieve_topk(params, b, cfg)
        if d.type == "cuda":
            check(eops.embedding_bag.launches - before == 2,
                  "MIND: the bag did not run in the card's requests")
        runs.append((scores.cpu(), vals.cpu(), idx.cpu()))
    (cs, cv, ci), (gs_, gv, gi) = runs
    err = float((gs_ - cs).abs().max())
    check(torch.allclose(gs_, cs, rtol=tol, atol=tol),
          f"MIND: card and CPU scores differ by {err}")
    check(torch.allclose(gv, cv, rtol=tol, atol=tol),
          "MIND: card and CPU top-100 scores differ")
    return {"tolerance": tol, "max_abs_err": err,
            "scores_compared": cs.numel(),
            "topk_indices_equal": bool(torch.equal(gi, ci))}


# ------------------------------------------------------ training phases ---

def launcher_opt(steps: int) -> dict:
    """The reference launcher's AdamW settings (repro/launch/train.py)."""
    return dict(lr=1e-3, warmup_steps=10, total_steps=steps)


def grads_nonzero(torch, trainer, batch) -> dict:
    """Key path -> whether step 1's gradient of that leaf is nonzero,
    through the trainer's own forward and backward (one host read)."""
    from repro_torch.tree import leaves

    _, _, grads = trainer.value_and_grad(trainer.state["params"], batch)
    named = list(leaves(grads))
    flags = torch.stack([g.ne(0).any() for _, g in named]).tolist()
    return {k: bool(f) for (k, _), f in zip(named, flags)}


def make_trainer(setup, steps, ckpt_dir=None):
    """A Trainer over ``setup`` = (params, loss_fn, data_fn) with the
    reference launcher's AdamW, logging every step."""
    from repro_torch.optim import optimizer
    from repro_torch.train import trainer

    params, loss_fn, data_fn = setup
    return trainer.Trainer(
        loss_fn, params, optimizer.AdamWConfig(**launcher_opt(steps)),
        trainer.TrainerConfig(total_steps=steps, log_every=1,
                              ckpt_dir=ckpt_dir, ckpt_every=10 ** 9),
        data_fn)


def train_lm_path(torch, dev, cfg, *, batch=2, seq=4096, steps=6,
                  reduced=None) -> dict:
    """``cfg`` trained by the port's Trainer from ``launch.train``'s setup
    (random weights from SEED on the card, ``lm_batch`` streams): step 1's
    gradients checked leaf by leaf, then ``steps`` steps counted from 0."""
    from repro_torch import kernels
    from repro_torch.launch import train as ltrain
    from repro_torch.tree import tree_leaves

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    setup = ltrain._lm_setup(cfg, batch, seq, dev, seed=SEED)
    t = make_trainer(setup, steps)
    sync(torch, dev)
    init_s = time.perf_counter() - t0
    nonzero = grads_nonzero(torch, t, setup[2](0))
    kernels.reset_launch_counts()
    log = t.run()
    launches = kernels.launch_counts()
    losses = [m["loss"] for _, m in log]
    med = sorted(t.step_times)[len(t.step_times) // 2]
    from repro_torch.launch import steps as steps_lib
    flops = steps_lib.lm_model_flops(cfg, "train", batch, seq)
    rep = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model,
           "n_params": sum(p.numel() for p in tree_leaves(setup[0])),
           "dtype": str(cfg.dtype).removeprefix("torch."),
           "attn_impl": cfg.attn_impl, "remat": cfg.remat, "batch": batch,
           "seq": seq, "steps": steps, "init_s": init_s, "losses": losses,
           "grad_norm": [m["grad_norm"] for _, m in log],
           "lr": [m["lr"] for _, m in log], "step_times_s": t.step_times,
           "median_step_s": med, "tokens_per_s": batch * seq / med,
           "model_flops_per_step": flops,
           "model_flops_share": flops / med / BF16_FLOPS,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
           "grad_leaves": len(nonzero),
           "zero_grad_leaves": [k for k, f in nonzero.items() if not f],
           "launches": launches, "stragglers": t.straggler_events}
    if reduced:
        rep["reduced"] = reduced
    check(all(math.isfinite(x) for x in losses),
          f"{cfg.name} training: a loss is not finite: {losses}")
    check(not rep["zero_grad_leaves"],
          f"{cfg.name} training: zero step-1 gradients in "
          f"{rep['zero_grad_leaves']}")
    check(rep["peak_mem_bytes"] < 80e9,
          f"{cfg.name} training: peak {rep['peak_mem_bytes']} B")
    return rep


def train_mind_path(torch, dev, *, batch=65536, steps=4) -> dict:
    """``configs/mind.py``'s full config trained by the port's Trainer
    (``launch.train``'s setup, ``mind_batch`` streams at the config's
    train_batch): step 1's gradients checked leaf by leaf, then ``steps``
    steps counted from 0, one bag launch a forward.  Making a batch is
    timed apart from the steps."""
    from repro_torch import kernels
    from repro_torch.configs import mind
    from repro_torch.launch import train as ltrain

    cfg = mind.config()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params, loss_fn, data_fn = ltrain._mind_setup(cfg, batch, dev, seed=SEED)
    data_s = []

    def timed_data(step):
        t0 = time.perf_counter()
        b = data_fn(step)
        sync(torch, dev)
        data_s.append(time.perf_counter() - t0)
        return b

    t = make_trainer((params, loss_fn, timed_data), steps)
    nonzero = grads_nonzero(torch, t, data_fn(0))
    kernels.reset_launch_counts()
    log = t.run()
    launches = kernels.launch_counts()
    losses = [m["loss"] for _, m in log]
    med = sorted(t.step_times)[len(t.step_times) // 2]
    rep = {"n_items": cfg.n_items, "embed_dim": cfg.embed_dim,
           "profile_vocab": cfg.profile_vocab, "seq_len": cfg.seq_len,
           "n_neg": cfg.n_neg, "batch": batch, "steps": steps,
           "losses": losses, "acc": [m["acc"] for _, m in log],
           "step_times_s": t.step_times, "median_step_s": med,
           "users_per_s": batch / med, "data_s": data_s,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
           "grad_nonzero": nonzero, "launches": launches}
    check(all(math.isfinite(x) for x in losses),
          f"MIND training: a loss is not finite: {losses}")
    check(all(nonzero.values()) and "d:profile_embed" in nonzero,
          f"MIND training: zero step-1 gradients: {nonzero}")
    check(launches["embedding_bag"] == steps,
          f"MIND training: the bag launched {launches['embedding_bag']} "
          f"times in {steps} forwards")
    return rep


def train_card_vs_cpu(torch, dev) -> dict:
    """qwen3-14b's smoke config (chunked attention, remat full),
    moonshot's (MoE, aux loss on) and MIND's, in f32 with TF32 off, one
    state on both devices through ``carry``: step 1's loss within 1e-5
    relative, every gradient leaf and every parameter after one Trainer
    step within 2e-4.  MIND's profile bag runs the kernel inside
    ``EmbeddingBagFn`` on the card (its backward plain torch) and the
    plain version on the CPU."""
    from repro_torch import carry
    from repro_torch.configs import mind as mind_cfg
    from repro_torch.configs import moonshot_v1_16b_a3b, qwen3_14b
    from repro_torch.kernels.embedding_bag import ops as eops
    from repro_torch.launch import train as ltrain
    from repro_torch.models import transformer as tf
    from repro_torch.models.recsys import mind
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tol = 2e-4
    out = {"loss_rtol": 1e-5, "tolerance": tol}
    for cfg in (qwen3_14b.smoke_config(attn_impl="chunked", remat="full"),
                moonshot_v1_16b_a3b.smoke_config(),
                mind_cfg.smoke_config()):
        is_lm = isinstance(cfg, tf.LMConfig)
        host = (tf.init if is_lm else mind.init)(
            cfg, torch.Generator().manual_seed(SEED), "cpu")
        tree = (carry.lm_params_to_numpy(host) if is_lm
                else carry.mind_params_to_numpy(host))
        runs = []
        for d in (torch.device("cpu"), dev):
            setup = (ltrain._lm_setup(cfg, 4, 32, d) if is_lm
                     else ltrain._mind_setup(cfg, 64, d))
            params = (carry.lm_params_from_numpy(tree, cfg, d) if is_lm
                      else carry.mind_params_from_numpy(tree, cfg, d))
            t = make_trainer((params,) + setup[1:], 1)
            before = eops.embedding_bag.launches
            loss, _, grads = t.value_and_grad(params, setup[2](0))
            t.run()
            if d.type == "cuda" and not is_lm:
                check(eops.embedding_bag.launches - before == 2,
                      f"{cfg.name}: the bag did not run in the card's "
                      f"forwards")
            runs.append((float(loss), [g.cpu() for g in tree_leaves(grads)],
                         [p.detach().cpu()
                          for p in tree_leaves(t.state["params"])]))
        (l_cpu, g_cpu, p_cpu), (l_card, g_card, p_card) = runs
        g_err = max(float((a - b).abs().max()) for a, b in zip(g_card, g_cpu))
        p_err = max(float((a - b).abs().max()) for a, b in zip(p_card, p_cpu))
        out[cfg.name] = {"loss_cpu": l_cpu, "loss_card": l_card,
                         "grad_max_abs_err": g_err,
                         "param_max_abs_err": p_err, "leaves": len(g_cpu)}
        check(abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu),
              f"{cfg.name}: card loss {l_card} vs CPU {l_cpu}")
        check(all(torch.allclose(a, b, rtol=tol, atol=tol)
                  for a, b in zip(g_card, g_cpu)),
              f"{cfg.name}: card and CPU gradients differ by {g_err}")
        check(all(torch.allclose(a, b, rtol=tol, atol=tol)
                  for a, b in zip(p_card, p_cpu)),
              f"{cfg.name}: card and CPU params after a step differ by "
              f"{p_err}")
    return out


def train_resume_check(torch, dev, steps=3) -> dict:
    """A bf16 trainer state (qwen3-14b's smoke width, chunked attention,
    remat full) saved on the card, ``steps`` steps run; then a trainer
    built from other weights restores it and runs the same steps: the
    final params must be bit-identical.  The store lives in a temporary
    directory, removed afterwards."""
    import tempfile

    from repro_torch.configs import qwen3_14b
    from repro_torch.launch import train as ltrain
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(qwen3_14b.smoke_config(
        attn_impl="chunked", remat="full"), dtype=torch.bfloat16)
    with tempfile.TemporaryDirectory(prefix="train_ckpt_") as d:
        first = make_trainer(ltrain._lm_setup(cfg, 4, 32, dev), steps,
                             ckpt_dir=d)
        first.save()
        first.run()
        again = make_trainer(ltrain._lm_setup(cfg, 4, 32, dev,
                                                     seed=SEED + 1),
                             steps, ckpt_dir=d)
        restored_step = again.step
        again.run()
    want = tree_leaves(first.state["params"])
    got = tree_leaves(again.state["params"])
    same = all(a.dtype == b.dtype == torch.bfloat16
               and torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in zip(want, got))
    check(restored_step == 0, f"resume: restored step {restored_step}")
    check(same, "resume: the restored run's bf16 params differ")
    return {"arch": cfg.name, "dtype": "bfloat16", "steps": steps,
            "restored_step": restored_step, "leaves": len(want),
            "bit_identical": same}


def flash_grad_refusal(torch, dev) -> dict:
    """``loss_fn`` through the flash kernel on the card (qwen3-14b's smoke
    config): the forward launches flash once a layer, the backward must
    raise."""
    from repro_torch.configs import qwen3_14b
    from repro_torch.data import pipeline
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves

    cfg = qwen3_14b.smoke_config(attn_impl="flash")
    params = tf.init(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    before = aops.mha.launches
    loss, _ = tf.loss_fn(params, pipeline.lm_batch(cfg.vocab, 2, 32, step=0,
                                                   device=dev), cfg)
    fwd = aops.mha.launches - before
    try:
        torch.autograd.grad(loss, leaves)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    check(fwd == cfg.n_layers, f"flash refusal: {fwd} forward launches")
    check(refused is not None and "chunked" in refused,
          "flash refusal: a backward through the flash kernel did not "
          "raise")
    return {"forward_launches": fwd, "raised": refused}


# ------------------------------------------------------------ GNN phases ---

GNN_ARCHS = ("egnn", "gatedgcn", "nequip", "mace")


def gnn_zero_grad_prefixes(arch: str, task: str, pos_zero: bool) -> tuple:
    """Key-path prefixes of the leaves whose step-1 gradient the
    reference's own loss leaves zero.  MACE's energy is the sum of its
    per-layer readouts, so its head goes unused there, and node
    classification reads the head, not the readouts.  On the sampled
    shape every position is zero (``sampled_block_batch``), so every edge
    is zero-length: EGNN's position update moves nothing, and NequIP's and
    MACE's convolutions mask every message, which leaves their radial
    MLPs, the mixing of the (zero) messages, MACE's products of them and
    every l > 0 channel (zero from the start) without a gradient."""
    out = []
    if arch == "mace":
        out.append("d:head" if task == "energy" else "d:layers|d:readout")
    if pos_zero and arch == "egnn":
        out.append("d:layers|d:phi_x")
    if pos_zero and arch in ("nequip", "mace"):
        out += ["d:layers|d:radial", "d:layers|d:skip|d:l1",
                "d:layers|d:skip|d:l2", "d:layers|d:gate"]
        out += (["d:layers|d:mix|"] if arch == "nequip" else
                ["d:layers|d:w2", "d:layers|d:w3", "d:layers|d:mix1",
                 "d:layers|d:mix2", "d:layers|d:mix3"])
    return tuple(out)


def ogb_cuts(n: int, e: int) -> dict:
    """Why gatedgcn, egnn and mace do not run at ogb_products on one
    80 GB card: the f32 activations their backward keeps, at N nodes and
    E edges (the reference streams edges in chunks for nequip and mace
    only, and mace's node-side products outgrow the card regardless)."""
    def gb(b):
        return f"{b / 1e9:.1f} GB"
    return {
        "gatedgcn": f"16 checkpointed layers each keep the [E, 70] edge "
                    f"carry ({gb(e * 70 * 4)} at E = {e}): "
                    f"{gb(16 * e * 70 * 4)}",
        "egnn": f"a layer's backward keeps its [E, 129] message input "
                f"({gb(e * 129 * 4)}) and the seven [E, 64] activations "
                f"of its two edge MLPs ({gb(7 * e * 64 * 4)}), and the "
                f"reference streams only nequip and mace in chunks",
        "mace": f"one [N, 128, 13] feature set is {gb(n * 128 * 13 * 4)} "
                f"at N = {n}, and a layer's products and mixes keep about "
                f"ten for the backward ({gb(10 * n * 128 * 13 * 4)})",
    }


def gnn_full_config(mod, shape: dict, **kw):
    """The arch's published config on ``shape`` as the reference's
    ``build_gnn`` sets it: energy (+ forces) on molecules, node
    classification otherwise, remat on."""
    if shape["kind"] == "train_mol":
        return mod.config(task="energy", n_classes=2,
                          d_feat=shape["d_feat"], n_graphs=shape["batch"],
                          remat=True, **kw)
    return mod.config(task="node_class", n_classes=shape["n_classes"],
                      d_feat=shape["d_feat"], n_graphs=1, remat=True, **kw)


def train_gnn_run(torch, dev, arch, shape_name, cfg, data_fn, *, steps,
                  n_nodes, n_edges, rate, pos_zero=False,
                  reduced=None) -> dict:
    """``cfg`` trained by the port's Trainer (random weights from SEED on
    the card, the reference launcher's AdamW) on ``data_fn``'s batches
    for ``steps`` steps, step 1's gradients checked leaf by leaf against
    the leaves the reference's loss leaves zero; making a batch (sampling
    included) is timed apart.  ``rate`` = (name, items a
    step)."""
    from repro_torch import configs
    from repro_torch.tree import leaves, tree_leaves

    model = configs.get(arch).MODULE
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    data_s = []

    def timed_data(step):
        t0 = time.perf_counter()
        b = data_fn(step)
        sync(torch, dev)
        data_s.append(time.perf_counter() - t0)
        return b

    t = make_trainer((params, lambda p, b: model.loss_fn(p, b, cfg),
                      timed_data), steps)
    # step 1's gradients, read as the step computes them (an extra
    # forward and backward would cost ogb_products two minutes)
    nonzero = {}
    value_and_grad = t.value_and_grad

    def step_value_and_grad(p, b):
        loss, metrics, grads = value_and_grad(p, b)
        if not nonzero:
            named = list(leaves(grads))
            flags = torch.stack([g.ne(0).any() for _, g in named]).tolist()
            nonzero.update({k: bool(f) for (k, _), f in zip(named, flags)})
        return loss, metrics, grads

    t.value_and_grad = step_value_and_grad
    log = t.run()
    losses = [m["loss"] for _, m in log]
    med = sorted(t.step_times)[len(t.step_times) // 2]
    from repro_torch.launch import steps as steps_lib
    flops = steps_lib.gnn_model_flops(arch, cfg, n_nodes, n_edges)
    prefixes = gnn_zero_grad_prefixes(arch, cfg.task, pos_zero)
    zero = sorted(k for k, f in nonzero.items() if not f)
    want_zero = sorted(k for k in nonzero if k.startswith(prefixes))
    rep = {"arch": arch, "shape": shape_name, "task": cfg.task,
           "n_layers": cfg.n_layers, "d_hidden": cfg.d_hidden,
           "n_params": sum(p.numel() for p in tree_leaves(params)),
           "n_nodes": n_nodes, "n_edges": n_edges, "remat": cfg.remat,
           "edge_chunk": getattr(cfg, "edge_chunk", 0), "steps": steps,
           "losses": losses, "step_times_s": t.step_times,
           "median_step_s": med, rate[0]: rate[1] / med,
           "data_s": data_s,
           "model_flops_per_step": flops,
           "model_flops_share": flops / med / F32_FLOPS,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
           "peak_reserved_bytes": torch.cuda.max_memory_reserved(dev),
           "grad_leaves": len(nonzero), "zero_grad_leaves": zero,
           "stragglers": t.straggler_events}
    if cfg.task == "energy" and arch != "gatedgcn":
        b = data_fn(0)
        pos = b["pos"].clone().requires_grad_()
        e = model.node_energy(t.state["params"], pos, b, cfg)
        forces = -torch.autograd.grad(e.sum(), pos)[0]
        rep["forces_finite"] = bool(torch.isfinite(forces).all())
        rep["max_abs_force"] = float(forces.abs().max())
        check(rep["forces_finite"], f"{arch} {shape_name}: forces not "
                                    f"finite")
    if reduced:
        rep["reduced"] = reduced
    tag = f"{arch} {shape_name}"
    check(all(math.isfinite(x) for x in losses),
          f"{tag}: a loss is not finite: {losses}")
    check(zero == want_zero,
          f"{tag}: zero step-1 gradients in {zero}, expected {want_zero}")
    # the reserve, not only the bytes allocated: what the card must hold
    check(rep["peak_reserved_bytes"] < 80e9,
          f"{tag}: peak {rep['peak_mem_bytes']} B allocated, "
          f"{rep['peak_reserved_bytes']} B reserved")
    return rep


# ogb_products' edges are padded with masked edges to a multiple of 64
# (60 of them), which build_gnn's 32 chunks divide
OGB_PAD = 64


def gnn_shape_data(torch, dev, name: str, shape: dict,
                   chunks: int = 0) -> dict:
    """One of the reference's GNN shapes on ``dev``: ``data_fn`` (step ->
    batch), the batch's node and edge counts, the rate a run reports
    (name, items a step), whether every position is zero, the config's
    shape-specific fields and what making the data took."""
    from repro_torch.configs import gnn_shapes
    from repro_torch.data import pipeline
    from repro_torch.graph import sampler

    out = {"pos_zero": False, "cfg_kw": {}, "info": {}}
    if shape["kind"] == "train_mol":
        out.update(
            data_fn=lambda s: pipeline.molecule_batch(
                shape["batch"], shape["n_nodes"], shape["n_edges"],
                shape["d_feat"], step=s, device=dev),
            n_nodes=shape["batch"] * shape["n_nodes"],
            n_edges=shape["batch"] * shape["n_edges"],
            rate=("graphs_per_s", shape["batch"]))
    elif shape["kind"] == "train_sampled":
        t0 = time.perf_counter()
        csr = sampler.make_synthetic_csr(
            shape["n_nodes"], round(shape["n_edges"] / shape["n_nodes"]),
            seed=SEED, device=dev)
        sync(torch, dev)
        out["info"] = {"csr_build_s": time.perf_counter() - t0,
                       "csr_edges": int(csr.indices.numel()),
                       "csr_indices_bytes": csr.indices.numel() * 4}
        g = torch.Generator(dev).manual_seed(SEED)
        feats = torch.randn((shape["n_nodes"], shape["d_feat"]),
                            generator=g, device=dev)
        labels = torch.randint(0, shape["n_classes"], (shape["n_nodes"],),
                               generator=g, device=dev, dtype=torch.int32)
        n_nodes, n_edges = gnn_shapes.sampled_block_dims(shape)
        out.update(
            data_fn=lambda s: pipeline.sampled_block_batch(
                csr, feats, labels, shape["batch_nodes"], shape["fanouts"],
                s),
            n_nodes=n_nodes, n_edges=n_edges, pos_zero=True,
            rate=("seeds_per_s", shape["batch_nodes"]))
    else:
        t0 = time.perf_counter()
        graph = pipeline.node_class_graph(
            shape["n_nodes"], shape["n_edges"], shape["d_feat"],
            shape["n_classes"], seed=SEED, device=dev)
        n_edges = shape["n_edges"]
        if name == "ogb_products":
            # pad with masked edges so the chunk count divides the edges,
            # as build_gnn's padding to the mesh's size does on a pod
            pad = -n_edges % OGB_PAD
            for k, fill in (("src", 0), ("dst", 0), ("edge_mask", False)):
                graph[k] = torch.cat([graph[k], torch.full(
                    (pad,), fill, dtype=graph[k].dtype, device=dev)])
            n_edges += pad
            out["cfg_kw"] = {"edge_chunk": n_edges // chunks}
            out["info"]["padded_edges"] = pad
        sync(torch, dev)
        out["info"]["graph_build_s"] = time.perf_counter() - t0
        out.update(data_fn=lambda s: graph, n_nodes=shape["n_nodes"],
                   n_edges=n_edges, rate=("nodes_per_s", shape["n_nodes"]))
    return out


def train_gnn_path(torch, dev, *, steps=4, ogb_steps=2, shapes=None,
                   archs=GNN_ARCHS) -> list:
    """The four GNNs at their published widths on the reference's input
    shapes (``configs/gnn_shapes.py``), TF32 off: molecule (energy and
    forces), full_graph_sm and minibatch_lg (node classification; the
    Reddit-sized CSR and feature table on the card, 1024 seeds sampled at
    fanouts 15, 10 each step), and nequip alone on ogb_products with its
    chunked-edge convolution (a child process, ``ogb_nequip``).  A name
    missing from ``shapes`` is not run.  One ``train_gnn`` line per
    run."""
    from repro_torch import configs
    from repro_torch.configs import gnn_shapes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shapes = shapes or gnn_shapes.gnn_shapes()
    reps = []
    for name in ("molecule", "full_graph_sm", "minibatch_lg",
                 "ogb_products"):
        if name not in shapes:
            continue
        if name == "ogb_products":
            if "nequip" in archs:
                reps.append(ogb_nequip(torch, dev, ogb_steps))
            continue
        shape = shapes[name]
        data = gnn_shape_data(torch, dev, name, shape)
        emit("gnn_shape", shape=name, **data["info"])
        for arch in archs:
            cfg = gnn_full_config(configs.get(arch), shape, **data["cfg_kw"])
            rep = train_gnn_run(
                torch, dev, arch, name, cfg, data["data_fn"], steps=steps,
                n_nodes=data["n_nodes"], n_edges=data["n_edges"],
                rate=data["rate"], pos_zero=data["pos_zero"])
            emit("train_gnn", **rep)
            reps.append(rep)
        del data
    return reps


def ogb_nequip(torch, dev, steps: int) -> dict:
    """nequip on ogb_products in a child process (``--ogb-nequip``) with
    the allocator's expandable segments on for that cell alone, so the
    other phases' memory stays comparable; build_gnn's chunk count on
    this card's mesh, run once.  The child fails if its reserve reaches
    80 GB (``train_gnn_run``), and so does this phase.  This process
    hands its cached memory back first: the child needs ~79 GB of the
    card's 85.  The child's lines pass through."""
    import os
    torch.cuda.empty_cache()
    emit("ogb_nequip_start",
         parent_allocated_bytes=torch.cuda.memory_allocated(dev),
         parent_reserved_bytes=torch.cuda.memory_reserved(dev))
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    r = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--ogb-nequip",
         str(steps)], capture_output=True, text=True, env=env, timeout=900)
    sys.stdout.write(r.stdout)
    sys.stdout.flush()
    runs = [json.loads(x) for x in r.stdout.splitlines()
            if x.startswith('{"phase": "train_gnn"')]
    if r.returncode != 0 or not runs:
        emit("ogb_nequip_failed", returncode=r.returncode,
             stderr_tail=r.stderr[-3000:])
        check(False, f"nequip on ogb_products at build_gnn's chunks "
                     f"failed: rc {r.returncode}")
    return runs[-1]


def ogb_nequip_child(steps: int) -> int:
    """The ogb_products cell alone (run by ``ogb_nequip``): the edge chunk
    from ``steps.build_gnn`` on the host mesh (one card)."""
    import torch
    from repro_torch import configs
    from repro_torch.configs import gnn_shapes
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as steps_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    shape = gnn_shapes.gnn_shapes()["ogb_products"]
    bundle = steps_lib.build("nequip", "ogb_products",
                             mesh_lib.make_host_mesh())
    n = bundle.meta["edge_chunks"]
    data = gnn_shape_data(torch, dev, "ogb_products", shape, chunks=n)
    emit("gnn_shape", shape="ogb_products", build_gnn=bundle.meta,
         alloc_conf="expandable_segments:True", **data["info"])
    cfg = gnn_full_config(configs.get("nequip"), shape, **data["cfg_kw"])
    reduced = {"archs": ogb_cuts(shape["n_nodes"], shape["n_edges"]),
               "edges": f"{shape['n_edges']} + "
                        f"{data['info']['padded_edges']} masked edges (a "
                        f"multiple of {OGB_PAD}), so that {n} chunks of "
                        f"{cfg.edge_chunk} divide them; build_gnn pads to "
                        f"the mesh's size (61859328 on 16x16; on one card "
                        f"{bundle.meta['edges']}, which {n} does not "
                        f"divide)"}
    rep = train_gnn_run(
        torch, dev, "nequip", "ogb_products", cfg, data["data_fn"],
        steps=steps, n_nodes=data["n_nodes"], n_edges=data["n_edges"],
        rate=data["rate"], pos_zero=data["pos_zero"], reduced=reduced)
    rep["edge_chunks"] = n
    emit("train_gnn", **rep)
    torch.distributed.destroy_process_group()
    return 0


def gnn_logits(arch, model, params, batch, cfg):
    """Per-node logits of a node-classification config, as its
    ``loss_fn`` computes them."""
    from repro_torch.models import common
    from repro_torch.models.gnn import common as gc

    if arch == "gatedgcn":
        h = model._forward(params, batch, cfg)
    elif arch == "egnn":
        h, _ = model._forward(params, batch["pos"], batch, cfg)
    elif arch == "nequip":
        h = gc.invariants(model._forward(params, batch["pos"], batch, cfg))
    else:
        h = gc.invariants(model._forward(params, batch["pos"], batch,
                                         cfg)[0])
    return common.mlp_apply(params["head"], h)


def gnn_smoke_batch(torch, pipeline, task, cfg, device):
    if task == "energy":
        b = pipeline.molecule_batch(cfg.n_graphs, 6, 12, cfg.d_feat, step=0,
                                    device=device)
    else:
        b = pipeline.node_class_graph(60, 240, cfg.d_feat, cfg.n_classes,
                                      seed=SEED, device=device)
    return {k: v.to(cfg.dtype) if v.is_floating_point() else v
            for k, v in b.items()}


def gnn_card_vs_cpu(torch, dev) -> dict:
    """Each GNN's smoke config (remat on) on both tasks, one state on both
    devices through ``carry``, TF32 off: the loss and the energies within
    1e-5 relative (energies: of the largest |energy|); logits, forces,
    every gradient leaf and every parameter after one Trainer step within
    rtol 2e-4 / atol 2e-5.  In f32, except MACE's energy task, in f64: its
    force loss differentiates twice through norms of near-zero features,
    and its f32 gradients stand over 10x that tolerance from its own f64
    answer on one device.  Then NequIP chunked (3 chunks)
    against unchunked on the card, and the sampler on the card against the
    CPU's, fed the same draws."""
    from repro_torch import carry, configs
    from repro_torch.data import pipeline
    from repro_torch.graph import sampler
    from repro_torch.models.gnn import nequip
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = torch.device("cpu")
    rtol, atol = 2e-4, 2e-5
    out = {"loss_rtol": 1e-5, "rtol": rtol, "atol": atol}

    def close(a, b, what, tag):
        check(all(x.shape == y.shape and torch.allclose(x, y, rtol=rtol,
                                                        atol=atol)
                  for x, y in zip(a, b)),
              f"{tag}: card and CPU {what} differ by "
              f"{max(float((x - y).abs().max()) for x, y in zip(a, b))}")
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    for arch in GNN_ARCHS:
        mod = configs.get(arch)
        for task in ("energy", "node_class"):
            f64 = arch == "mace" and task == "energy"
            cfg = mod.smoke_config(
                task=task, n_classes=3, remat=True,
                dtype=torch.float64 if f64 else torch.float32)
            tree = carry.gnn_params_to_numpy(mod.MODULE.init(
                cfg, torch.Generator().manual_seed(SEED), cpu))
            runs = []
            for d in (cpu, dev):
                batch = gnn_smoke_batch(torch, pipeline, task, cfg, d)
                params = carry.gnn_params_from_numpy(tree, cfg, d)
                t = make_trainer((params, lambda p, b: mod.MODULE.loss_fn(
                    p, b, cfg), lambda s: batch), 1)
                loss, _, grads = t.value_and_grad(params, batch)
                if task == "energy":
                    pos = batch["pos"].clone().requires_grad_()
                    e = mod.MODULE.node_energy(params, pos, batch, cfg)
                    outs = [e.detach()]
                    if arch != "gatedgcn":
                        outs.append(-torch.autograd.grad(e.sum(), pos)[0])
                else:
                    with torch.no_grad():
                        outs = [gnn_logits(arch, mod.MODULE, params, batch,
                                           cfg)]
                t.run()
                runs.append((float(loss), [o.cpu() for o in outs],
                             [g.cpu() for g in tree_leaves(grads)],
                             [p.detach().cpu()
                              for p in tree_leaves(t.state["params"])]))
            (l_cpu, o_cpu, g_cpu, p_cpu), (l_card, o_card, g_card,
                                           p_card) = runs
            tag = f"{arch} {task}"
            rep = {"dtype": "float64" if f64 else "float32",
                   "loss_cpu": l_cpu, "loss_card": l_card,
                   "leaves": len(g_cpu)}
            check(abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu),
                  f"{tag}: card loss {l_card} vs CPU {l_cpu}")
            if task == "energy":
                e_err = float((o_card[0] - o_cpu[0]).abs().max())
                rep["energy_max_abs_err"] = e_err
                check(e_err <= 1e-5 * float(o_cpu[0].abs().max()),
                      f"{tag}: card energies differ by {e_err}")
                if len(o_cpu) > 1:
                    rep["forces_max_abs_err"] = close(
                        o_card[1:], o_cpu[1:], "forces", tag)
            else:
                rep["logits_max_abs_err"] = close(o_card, o_cpu, "logits",
                                                  tag)
            rep["grad_max_abs_err"] = close(g_card, g_cpu, "gradients", tag)
            rep["param_max_abs_err"] = close(p_card, p_cpu,
                                             "params after a step", tag)
            out[f"{arch}_{task}"] = rep

    # nequip chunked (3 chunks of 8 edges) against unchunked, on the card
    cfg = configs.get("nequip").smoke_config(remat=True)
    params = nequip.init(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    batch = gnn_smoke_batch(torch, pipeline, "energy", cfg, dev)
    n_e = batch["src"].shape[0]
    res = []
    for c in (cfg, dataclasses.replace(cfg, edge_chunk=n_e // 3)):
        pos = batch["pos"].clone().requires_grad_()
        e = nequip.node_energy(params, pos, batch, c)
        res.append((e.detach(), torch.autograd.grad(e.sum(),
                                                    leaves + [pos])))
    (e1, g1), (e2, g2) = res
    e_err = float((e1 - e2).abs().max())
    g_err = max(float((a - b).abs().max()) for a, b in zip(g1, g2))
    out["nequip_chunked"] = {"edges": n_e, "chunks": 3,
                             "energy_max_abs_err": e_err,
                             "grad_max_abs_err": g_err}
    check(torch.allclose(e1, e2, rtol=1e-5, atol=1e-6),
          f"nequip chunked energies differ by {e_err}")
    check(all(torch.allclose(a, b, rtol=2e-3, atol=1e-5)
              for a, b in zip(g1, g2)),
          f"nequip chunked gradients differ by {g_err}")

    # the sampler: the same draws on both devices
    g = torch.Generator().manual_seed(SEED)
    fanouts, n_seeds = (15, 10), 256
    draws, n = [], n_seeds
    for f in fanouts:
        draws.append(torch.randint(0, sampler.DRAW_HIGH, (n, f),
                                   generator=g))
        n *= f
    feats = torch.randn((4000, 8), generator=g)
    labels = torch.randint(0, 5, (4000,), generator=g, dtype=torch.int32)
    got = []
    for d in (cpu, dev):
        csr = sampler.make_synthetic_csr(4000, 30, seed=SEED, device=d)
        b = pipeline.sampled_block_batch(csr, feats.to(d), labels.to(d),
                                         n_seeds, fanouts, step=3,
                                         draws=draws)
        got.append([x.cpu() for x in (csr.indptr, csr.indices)] +
                   [b[k].cpu() for k in sorted(b)])
    same = all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(*got))
    out["sampler"] = {"n_nodes": 4000, "n_edges": int(got[0][1].numel()),
                      "seeds": n_seeds, "fanouts": list(fanouts),
                      "identical": same}
    check(same, "the sampler on the card differs from the CPU's")
    return out


BASELINE_RUNS = ("apply_batch", "sequential_apply", "coarse_apply",
                 "static_per_batch_apply")


# ------------------------------------------------------------ phase 20 ---

def _same(torch, a, b) -> bool:
    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def bundle_path(torch, dev, *, shapes=("update_1m", "update_16m"),
                n_steps=4, preload_deg=2, mind_requests=4) -> dict:
    """The launch layer's step bundles (``launch.steps.build``) on the
    host mesh (``make_host_mesh``: one card, 1x1), run at the configs' own
    shapes: smscc's update cells (booted with update_1m's preload degree,
    ``n_steps`` batches of the paper's mix), community_query on the last
    update state, MIND's serve_p99.  Each bundle's result must equal the
    port's function called directly on the same inputs (a check of the
    bundle's plumbing), and against an independent reference: the SMSCC
    labels a static recompute, the query a plain expression, one MIND
    request the scores with the bag's plain version; the launch counts
    are set to 0 before each bundle's run and read after it."""
    import numpy as np

    from repro_torch import configs, kernels
    from repro_torch.core import community, dynamic
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as steps_lib
    from repro_torch.graph import segment_ops as so
    from repro_torch.kernels.embedding_bag import ref as eref
    from repro_torch.launch import workload
    from repro_torch.models.recsys import mind
    from repro_torch.tree import tree_map

    mesh = mesh_lib.make_host_mesh(device_type=dev.type)
    check(tuple(mesh.shape) == (1, 1), f"host mesh {mesh}")
    smscc = configs.get("smscc")
    out = {"mesh": f"{mesh.shape}", "cells": {}}
    state = cfg = None
    for name in shapes:
        b = steps_lib.build("smscc", name, mesh)
        shape = smscc.SHAPES[name]
        cfg = smscc.config(n_vertices=shape["n_vertices"],
                           edge_capacity=shape["edge_capacity"])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        state, n_pre = boot_state(torch, dev, cfg, preload_deg)
        sync(torch, dev)
        boot_s = time.perf_counter() - t0
        ops = [tree_map(lambda x: x.to(dev), workload.op_stream(
            cfg.n_vertices, shape["batch"], step=s, add_frac=0.7,
            seed=SEED)) for s in range(n_steps)]
        direct = tree_map(torch.clone, state)
        kernels.reset_launch_counts()
        sync(torch, dev)
        t0 = time.perf_counter()
        oks = []
        for o in ops:
            state, ok = b.fn(state, o)
            oks.append(ok)
        sync(torch, dev)
        run_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        same = True
        for o, ok in zip(ops, oks):
            direct, want = dynamic.apply_batch(direct, o, cfg)
            same = same and torch.equal(ok, want)
        same = same and _same(torch, state, direct)
        labels_ok = torch.equal(dynamic.recompute(state, cfg).ccid,
                                state.ccid)
        rep = {"n_vertices": cfg.n_vertices,
               "edge_capacity": cfg.edge_capacity, "batch": shape["batch"],
               "steps": n_steps, "preloaded_edges": n_pre,
               "boot_s": boot_s, "step_s": run_s / n_steps,
               "ops_per_s": shape["batch"] * n_steps / run_s,
               "peak_mem_bytes": peak, "launches": launches,
               "equals_direct": same, "labels_equal_recompute": labels_ok,
               "meta": b.meta}
        out["cells"][name] = rep
        emit("bundle", cell=f"smscc:{name}", **rep)
        check(same, f"smscc:{name}: the bundle differs from apply_batch")
        check(labels_ok, f"smscc:{name}: labels differ from a recompute")
        for k in ("frontier_min", "hash_probe"):
            check(launches[k] > 0, f"smscc:{name}: {k} never launched")
        if name != shapes[-1]:
            del state, direct, ops
    # community_query: 262144 (u, v) pairs against the last update state
    name = "community_query"
    b = steps_lib.build("smscc", name, mesh)
    q = smscc.SHAPES[name]["batch"]
    g = torch.Generator(device=dev).manual_seed(SEED)
    u, v = (torch.randint(0, cfg.n_vertices, (q,), generator=g, device=dev,
                          dtype=torch.int32) for _ in range(2))
    sync(torch, dev)
    t0 = time.perf_counter()
    got = b.fn(state, u, v)
    sync(torch, dev)
    run_s = time.perf_counter() - t0
    want = community.check_scc(state, u, v)
    plain = (state.v_alive[u.long()] & state.v_alive[v.long()]
             & (state.ccid[u.long()] == state.ccid[v.long()]))
    rep = {"queries": q, "n_vertices": cfg.n_vertices, "step_s": run_s,
           "queries_per_s": q / run_s, "same_scc": int(got.sum()),
           "equals_direct": bool(torch.equal(got, want)),
           "equals_plain": bool(torch.equal(got, plain)), "meta": b.meta}
    out["cells"][name] = rep
    emit("bundle", cell=f"smscc:{name}", **rep)
    check(rep["equals_direct"] and rep["equals_plain"],
          "smscc:community_query differs from check_scc")
    del state, u, v, got, want, plain
    torch.cuda.empty_cache()
    # mind:serve_p99 on the full 2^21-row table
    name = "serve_p99"
    b = steps_lib.build("mind", name, mesh)
    mcfg = configs.get("mind").config(scan_unroll=True)
    shape = configs.get("mind").SHAPES[name]
    params = mind.init(mcfg, torch.Generator(dev).manual_seed(SEED), dev)
    rng = np.random.default_rng(SEED)

    def ids(lo, hi, size):
        return torch.as_tensor(rng.integers(lo, hi, size), dtype=torch.int32,
                               device=dev)

    reqs = [{"behavior": ids(-1, mcfg.n_items, (shape["batch"],
                                                 mcfg.seq_len)),
             "profile": ids(-1, mcfg.profile_vocab,
                            (shape["batch"], mcfg.profile_len)),
             "candidates": ids(0, mcfg.n_items, (shape["batch"],
                                                 shape["n_cand"]))}
            for _ in range(mind_requests)]
    b.fn(params, reqs[0])
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    sync(torch, dev)
    t0 = time.perf_counter()
    scores = [b.fn(params, r) for r in reqs]
    sync(torch, dev)
    run_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    same = all(torch.equal(s, mind.serve_score(params, r, mcfg))
               for s, r in zip(scores, reqs))
    # an independent reference for the kernel's part: one request scored
    # with the bag's plain version (kernels/embedding_bag/ref) on the same
    # card tensors, at the bag's tolerance
    bag = so.bag_ops.embedding_bag
    so.bag_ops.embedding_bag = eref.embedding_bag
    try:
        plain = mind.serve_score(params, reqs[0], mcfg)
    finally:
        so.bag_ops.embedding_bag = bag
    plain_err = float((scores[0] - plain).abs().max())
    plain_ok = bool(torch.allclose(scores[0], plain, rtol=1e-5, atol=1e-5))
    rep = {"requests": mind_requests, "batch": shape["batch"],
           "n_cand": shape["n_cand"], "step_s": run_s / mind_requests,
           "scores_per_s": mind_requests * shape["batch"] * shape["n_cand"]
           / run_s, "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
           "launches": launches, "equals_direct": same,
           "plain_bag_tolerance": 1e-5, "plain_bag_max_abs_err": plain_err,
           "equals_plain_bag": plain_ok,
           "finite": all(bool(torch.isfinite(s).all()) for s in scores),
           "meta": b.meta}
    out["cells"]["mind:" + name] = rep
    emit("bundle", cell=f"mind:{name}", **rep)
    check(same and rep["finite"], "mind:serve_p99 differs from serve_score")
    check(plain_ok, f"mind:serve_p99 differs from the plain bag's scores "
                    f"by {plain_err}")
    check(launches["embedding_bag"] == mind_requests,
          f"mind:serve_p99: the bag launched {launches['embedding_bag']} "
          f"times for {mind_requests} requests")
    return out


def blockmm_steps_check(torch, dev, n=512) -> dict:
    """``reach_blockmm.ops.frontier_step`` and ``closure`` on the card
    (each product one bool_matmul launch) against their plain forms on
    the CPU, exactly."""
    from repro_torch import kernels
    from repro_torch.kernels.reach_blockmm import ops as bops
    from repro_torch.kernels.reach_blockmm import ref as bref

    g = torch.Generator(device=dev).manual_seed(SEED)
    adj = torch.rand((n, n), generator=g, device=dev) < 4.0 / n
    f = torch.rand((n, 32), generator=g, device=dev) < 0.02
    kernels.reset_launch_counts()
    step = bops.frontier_step(adj, f)
    clo = bops.closure(adj)
    sync(torch, dev)
    launches = kernels.launch_counts()["bool_matmul"]
    rep = {"n": n, "launches": launches,
           "frontier_step_equal": bool(torch.equal(
               step.cpu(), bref.frontier_step(adj.cpu(), f.cpu()))),
           "closure_equal": bool(torch.equal(clo.cpu(),
                                             bref.closure(adj.cpu()))),
           "closure_true": int(clo.sum())}
    check(rep["frontier_step_equal"] and rep["closure_equal"],
          f"frontier_step / closure differ from their plain forms: {rep}")
    check(launches == 1 + max(1, (n - 1).bit_length()),
          f"bool_matmul launched {launches} times")
    return rep


def dryrun_cell(arch="smscc", shape="update_1m") -> dict:
    """One dry-run cell on the 16x16 mesh in a child process with its own
    fake process group of 256 ranks; its record."""
    import os
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "dryrun.jsonl")
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out", out], capture_output=True,
            text=True, timeout=600, cwd=str(ROOT),
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        check(r.returncode == 0, f"dry-run failed: {r.stderr[-2000:]}")
        with open(out) as fh:
            rec = json.loads(fh.readline())
    check(rec["status"] == "ok", f"dry-run cell: {rec}")
    return rec


def baselines_path(torch, dev, nv=2 ** 14, cap=2 ** 16, b=256) -> dict:
    """The paper's §7 comparison on the card: one seeded graph (out-degree
    2 preload + recompute) and one batch of ``b`` ops of the paper's mix
    (add_frac 0.7, vertex ops on) through ``dynamic.apply_batch`` at B = b
    (three times, from the same boot), ``sequential_apply``,
    ``coarse_apply`` and ``static_per_batch_apply``, each from the boot
    state, timed to a synchronise (ops/s = b / seconds).  Every one must
    end on labels equal to a static recompute of its own graph; all four
    on one graph and one labelling (seed 0's ops hold no pair whose
    order changes the graph: no vertex is both added and removed); the
    two one-op-at-a-time baselines on one state and one set of acks.
    Recorded, not gated on: the speed ratios."""
    from repro_torch import kernels
    from repro_torch.configs import smscc
    from repro_torch.core import baselines, dynamic
    from repro_torch.launch import workload

    cfg = smscc.config(n_vertices=nv, edge_capacity=cap)
    boot, n_pre = boot_state(torch, dev, cfg, 2)
    ops = workload.op_stream(nv, b, step=0, add_frac=0.7, seed=SEED)
    ops = dynamic.OpBatch(*(x.to(dev) for x in ops))
    sync(torch, dev)

    def timed(fn):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        st, ok = fn(boot, ops, cfg)
        sync(torch, dev)
        return st, ok, time.perf_counter() - t0, kernels.launch_counts()

    runs = {}
    batch_s = []
    for _ in range(3):
        st, ok, sec, launches = timed(dynamic.apply_batch)
        batch_s.append(sec)
    runs["apply_batch"] = (st, ok, min(batch_s), launches)
    for name in ("sequential_apply", "coarse_apply",
                 "static_per_batch_apply"):
        runs[name] = timed(getattr(baselines, name))

    def edges(st):
        live = st.edges.state == 1
        pairs = (st.edges.src[live].long() * nv + st.edges.dst[live].long())
        return pairs.sort().values

    ref_st = runs["apply_batch"][0]
    out = {"n_vertices": nv, "edge_capacity": cap, "ops": b,
           "preload_edges": n_pre, "apply_batch_s_each": batch_s}
    for name, (st, ok, sec, launches) in runs.items():
        fresh = dynamic.recompute(st, cfg)
        check(torch.equal(fresh.ccid, st.ccid),
              f"baselines: {name}'s labels differ from a static recompute")
        check(torch.equal(st.ccid, ref_st.ccid)
              and torch.equal(st.v_alive, ref_st.v_alive)
              and torch.equal(edges(st), edges(ref_st)),
              f"baselines: {name} ends on another graph or labelling than "
              f"apply_batch")
        out[name] = {"seconds": sec, "ops_per_s": b / sec,
                     "acked": int(ok.sum()), "launches": launches,
                     "acks_equal_apply_batch": bool(torch.equal(
                         ok, runs["apply_batch"][1]))}
    seq, coarse = runs["sequential_apply"], runs["coarse_apply"]
    check(torch.equal(seq[1], coarse[1]),
          "baselines: sequential and coarse acks differ")
    for name in ("sequential_apply", "coarse_apply",
                 "static_per_batch_apply"):
        out[name]["apply_batch_speedup"] = \
            out["apply_batch"]["ops_per_s"] / out[name]["ops_per_s"]
    return out


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
    from repro_torch.core.sync import SYNCS
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
    s0 = SYNCS.count
    rep["plain_s"] = feed(plain)
    rep["plain_ops_per_s"] = n_chunks * chunk / rep["plain_s"]
    st = plain.stats()
    rep["plain_host_syncs_per_step"] = (SYNCS.count - s0) / max(1, sum(
        st[f"repair_{t}_steps"] for t in
        ("dense", "compact", "full", "skipped")))
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
    counts are set to 0 just before and read just after (the scc form's
    apart).  Checks: every
    tenant's acks, generations, config and final state equal a port
    ``SCCService`` of its own fed the same chunks on the card (that run's
    wall time gives the sequential ops/s); maintained labels equal a
    static recompute for ``sample`` tenants and for all of class A; the
    compact tier and a solo replay ran; on a card the step graphs
    captured stay within the engine's compile bound.  Then: host syncs
    per wave of class A at T = ``n_a`` against a ``t_small``-tenant
    engine on the same traffic, at most 1.5 on a card; 8 tenants
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
    from repro_torch.core import dynamic, step_graph
    from repro_torch.core import graph_state as gs
    from repro_torch.core.service import SCCService
    from repro_torch.core.sync import SYNCS
    from repro_torch.kernels.frontier_expand import ops as fops
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
    captures = step_graph.captures
    acks, walls, syncs = run_waves(eng, tids)
    rep["launches"] = kernels.launch_counts()
    rep["lane_launches"] = kernels.lane_launch_counts()
    rep["scc_launches"] = fops.frontier_min.scc_launches
    rep["step_graph_captures"] = step_graph.captures - captures
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
    if cuda:  # the lane graphs, and the solo replays' step graphs
        check(0 < rep["step_graph_captures"] <= st["compile_bound"],
              f"{rep['step_graph_captures']} step graph captures, bound "
              f"{st['compile_bound']}")

    # the oracle: one port SCCService per tenant, the same chunks
    t0 = time.perf_counter()
    for tid in tids:
        svc = SCCService(cfgs[tid[0]], buckets=(chunk,),
                         state=gs.lane(boots[tid[0]], int(tid[1:])))
        for w in range(waves):
            ok, gen = svc._apply_ops(*ops[tid][w])
            check(not isinstance(acks[w][tid], Exception),
                  f"{tid} wave {w}: the engine failed: {acks[w][tid]!r}")
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
    # every class-A tenant: one lane-batched static recompute for each
    # config they hold now (a tenant that overflowed has grown)
    by_cfg = {}
    for i in range(n_a):
        by_cfg.setdefault(eng.tenant_cfg(f"a{i}"), []).append(
            eng.tenant_state(f"a{i}"))
    for cfg, states in by_cfg.items():
        lanes = gs.stack(states)
        check(torch.equal(dynamic.recompute(lanes, cfg).ccid, lanes.ccid),
              f"class A at {cfg.edge_capacity} slots: maintained labels "
              f"differ from a static recompute")
    rep["class_a_recompute_equal"] = {c.edge_capacity: len(v)
                                      for c, v in by_cfg.items()}
    del eng, by_cfg, lanes

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
    if cuda:  # the flush's one transfer; the lane step reads nothing
        check(max(per_wave_big, per_wave_small) <= 1.5,
              f"class A: {per_wave_big} / {per_wave_small} host syncs a "
              f"wave at T={n_a} / {t_small}, more than 1.5")

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
    """Wait for the card; never while another thread captures a step
    graph (the card refuses a device-wide wait during any capture)."""
    from repro_torch.core import step_graph
    step_graph.synchronize(dev)


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

    main_rep, _ = serve_path(torch, dev, **SERVE_CELLS["update_1m"],
                             budget_s=300.0)
    emit("main_path", **main_rep)
    if main_rep["chunks"] < main_rep["chunks_asked"]:
        emit("main_path_cut", chunks=main_rep["chunks"],
             asked=main_rep["chunks_asked"], reason="time budget")
    for k in ("frontier_min", "hash_probe"):
        check(main_rep["launches"][k] > 0, f"{k} never launched")
    check(main_rep["hash_probe_launches"]["insert"] > 0,
          "hash_probe's insert entry never launched")
    check(main_rep["fixpoint_launches"] == main_rep["launches"][
        "frontier_min"] > 0, "a fixpoint of the main path ran from the host")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dense_rep, _ = serve_path(torch, dev, **SERVE_CELLS["dense_tier"])
    emit("dense_tier", seconds=time.perf_counter() - t0, **dense_rep)
    check(dense_rep["launches"]["bool_matmul"] > 0,
          "bool_matmul never launched")
    check(dense_rep["repair_steps"]["dense"] > 0, "dense tier never ran")
    for tag, r in (("update_1m", main_rep), ("dense tier", dense_rep)):
        check(r["update_host_syncs_per_step"] == 0,
              f"{tag}: {r['update_host_syncs_per_step']} host syncs a step")
    if main_rep["chunks"] == main_rep["chunks_asked"]:
        # the reference's rounds on this seeded stream (the round loop's
        # launches counted them the same)
        check((main_rep["frontier_rounds_per_step"],
               main_rep["trim_rounds_per_step"]) == (99.90625, 8.0625),
              "update_1m's fixpoint rounds a step moved")

    t0 = time.perf_counter()
    sg = {cell: step_graph_checks(torch, dev, cell,
                                  cpu=cell == "dense_tier")
          for cell in ("update_1m", "dense_tier")}
    emit("step_graph", seconds=time.perf_counter() - t0, **sg)
    torch.cuda.empty_cache()

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

    t0 = time.perf_counter()
    base_rep = baselines_path(torch, dev)
    emit("baselines_path", seconds=time.perf_counter() - t0, **base_rep)
    for k in ("frontier_min", "hash_probe"):
        check(all(base_rep[r]["launches"][k] > 0 for r in BASELINE_RUNS),
              f"baselines: {k} did not launch in every run")
    from repro_torch.core import step_graph
    step_graph.clear()  # the step graphs' pools, before the LM phases
    torch.cuda.empty_cache()

    bag_rep = bag_path(torch, dev)
    emit("embedding_bag_path", **bag_rep)
    check(bag_rep["launches"]["embedding_bag"] == bag_rep["calls"],
          "embedding_bag did not launch on every call of its path")
    torch.cuda.empty_cache()

    from repro_torch.configs import (moonshot_v1_16b_a3b, qwen3_14b,
                                     qwen3_moe_235b_a22b)
    lm_rep = lm_path(torch, dev, qwen3_14b.config(attn_impl="flash"))
    emit("lm_main_path", **lm_rep)
    torch.cuda.empty_cache()

    moe_reps = {}
    for tag, cfg, reduced in (
            ("moonshot", moonshot_v1_16b_a3b.config(attn_impl="flash"),
             None),
            ("qwen3_moe", dataclasses.replace(
                qwen3_moe_235b_a22b.config(attn_impl="flash"), n_layers=4),
             {"n_layers": "94 -> 4: 235093610496 parameters (470 GB in "
                          "bf16) do not fit one 80 GB card; width, "
                          "experts and heads are full"})):
        rep = lm_path(torch, dev, cfg, steps=16, reduced=reduced)
        emit("moe_lm_path", **rep)
        moe_reps[tag] = rep
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    lm_cmp = lm_card_vs_cpu(torch, dev)
    emit("lm_card_vs_cpu", seconds=time.perf_counter() - t0, **lm_cmp)

    t0 = time.perf_counter()
    mind_rep = mind_path(torch, dev)
    emit("mind_path", seconds=time.perf_counter() - t0, **mind_rep)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mind_cmp = mind_card_vs_cpu(torch, dev)
    emit("mind_card_vs_cpu", seconds=time.perf_counter() - t0, **mind_cmp)

    t0 = time.perf_counter()
    full = qwen3_14b.config(attn_impl="chunked", remat="full")
    depth = 4
    train_lm = train_lm_path(torch, dev, dataclasses.replace(
        full, n_layers=depth), reduced={
            "n_layers": f"{full.n_layers} -> {depth}: the train state is 12 "
                        f"bytes a parameter (bf16 params and grads, f32 m "
                        f"and v), {12 * full.n_params()} B at "
                        f"{full.n_params()} parameters, beyond one 80 GB "
                        f"card; width, heads and vocab are full",
            "batch": "256 -> 2 sequences of 4096 tokens (the reference "
                     "launcher's 256 x 4096 is a pod's batch): f32 logits "
                     "and their gradient take ~5 GB a sequence"})
    emit("train_lm", seconds=time.perf_counter() - t0, **train_lm)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_mind = train_mind_path(torch, dev)
    emit("train_mind", seconds=time.perf_counter() - t0, **train_mind)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_cmp = train_card_vs_cpu(torch, dev)
    emit("train_card_vs_cpu", seconds=time.perf_counter() - t0, **train_cmp)
    t0 = time.perf_counter()
    resume = train_resume_check(torch, dev)
    emit("train_resume", seconds=time.perf_counter() - t0, **resume)
    emit("flash_grad_refusal", **flash_grad_refusal(torch, dev))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    emit("train_gnn_start", allocated_bytes=torch.cuda.memory_allocated(dev),
         reserved_bytes=torch.cuda.memory_reserved(dev))
    train_gnn_path(torch, dev)
    emit("train_gnn_done", seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gnn_cmp = gnn_card_vs_cpu(torch, dev)
    emit("gnn_card_vs_cpu", seconds=time.perf_counter() - t0, **gnn_cmp)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    bundles = bundle_path(torch, dev)
    emit("bundles", seconds=time.perf_counter() - t0,
         mesh=bundles["mesh"], cells=sorted(bundles["cells"]))
    torch.distributed.destroy_process_group()
    step_graph.clear()
    torch.cuda.empty_cache()
    emit("blockmm_steps", **blockmm_steps_check(torch, dev))
    t0 = time.perf_counter()
    rec = dryrun_cell()
    emit("dryrun_cell", seconds=time.perf_counter() - t0, record=rec)

    # hash_probe: the insert entry's launches, the form its entry times;
    # all three entries' launches stand beside them.  flash and the bag:
    # the launches of every path that runs them, each path counted from 0
    flash_by_path = {"qwen3_14b": lm_rep["launches"]["flash_attention"],
                     **{k: r["launches"]["flash_attention"]
                        for k, r in moe_reps.items()}}
    bag_by_path = {"mind_" + k: mind_rep[k]["launches"]["embedding_bag"]
                   for k in ("serve_p99", "retrieval_cand")}
    bag_by_path["bag_path"] = bag_rep["launches"]["embedding_bag"]
    bag_by_path["train_mind"] = train_mind["launches"]["embedding_bag"]
    by_path = {"flash_attention": flash_by_path,
               "embedding_bag": bag_by_path,
               "frontier_min": {"baselines": {
                   k: base_rep[k]["launches"]["frontier_min"]
                   for k in BASELINE_RUNS}},
               "hash_probe": {"baselines": {
                   k: base_rep[k]["launches"]["hash_probe"]
                   for k in BASELINE_RUNS}}}
    launches = {"frontier_min": main_rep["launches"]["frontier_min"],
                "hash_probe": main_rep["hash_probe_launches"]["insert"],
                "bool_matmul": dense_rep["launches"]["bool_matmul"],
                "flash_attention": sum(flash_by_path.values()),
                "embedding_bag": sum(bag_by_path.values())}
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
             **({"fixpoint": dict(
                 launches=main_rep["fixpoint_launches"],
                 rounds=main_rep["fixpoint_rounds"],
                 rows=kern[name]["fixpoints"]),
                 "round": kern[name]["round"]}
                if name == "frontier_min" else {}),
             **({"launches_by_path": by_path[name]} if name in by_path
                else {}),
             **({"moe_shapes": kern["flash_attention_moe"]}
                if name == "flash_attention" else {}),
             **({"train_shape": kern["embedding_bag_train"]}
                if name == "embedding_bag" else {}),
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
        if sys.argv[1:2] == ["--ogb-nequip"]:
            sys.exit(ogb_nequip_child(int(sys.argv[2])))
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        sys.exit(2)
