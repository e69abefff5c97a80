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
9. the kernels line (JSON), the card line, and the device line last.

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

    launches = {"frontier_min": main_rep["launches"]["frontier_min"],
                "hash_probe": main_rep["launches"]["hash_probe"],
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
