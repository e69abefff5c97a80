"""Serving driver for the port: batched LM decode, or the paper's streaming
SCC service.

    python -m repro_torch.launch.serve --steps 64
    python -m repro_torch.launch.serve --steps 8 --device cpu
    python -m repro_torch.launch.serve --steps 64 --readers 2
    python -m repro_torch.launch.serve --steps 20 --readers 2 \
        --replicas 2 --dir /tmp/scc-store
    python -m repro_torch.launch.serve --tenants 4 --steps 32
    python -m repro_torch.launch.serve --tenants 4 --steps 8 --dir /tmp/t \
        --device cpu
    python -m repro_torch.launch.serve --arch qwen3-14b --device cpu --steps 4

``--arch smscc`` (the default): a typed GraphClient update stream with
SameSCC / Reachable query batches between chunks, over an SCCService
booted with every vertex slot live; ``--readers N`` moves the queries to
N reader threads over one shared broker, and ``--replicas N --dir D``
makes the store durable (a WAL-backed writer in ``D``) and serves the
readers from N replicas tailing its log; ``--tenants N`` serves N
independent graphs behind one lane-batched engine and admission queue
(with ``--dir D``, each tenant durable under ``D/tenants``).  An LM arch:
the arch's smoke config with random weights serves one batch of prompts,
prefill then greedy decode.  Runs on ``cuda`` unless ``--device`` says
otherwise.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs import smscc
from repro_torch.core import graph_state as gs
from repro_torch.core.service import SCCService
from repro_torch.launch import stream
from repro_torch.models import transformer as tf


def serve_smscc(steps: int, nv: int = 2048, chunk: int = 256,
                readers: int = 0, replicas: int = 0,
                directory: str | None = None,
                device: str = gs.DEFAULT_DEVICE) -> stream.StreamReport:
    """The paper's on-line mode: a typed GraphClient update stream and
    query batches over the committed snapshot.  With ``readers > 0`` the
    queries move to per-reader client sessions over one QueryBroker that
    overlaps the update pipeline.  With ``replicas > 0`` the store goes
    durable instead: a WAL-backed writer plus N read replicas tailing the
    log serve the readers' read-your-writes rounds
    (:func:`repro_torch.launch.replica.run_replicated_stream`; needs
    ``directory`` for the durable store)."""
    if replicas > 0:
        from repro_torch.launch.replica import run_replicated_stream
        if directory is None:
            raise SystemExit("--replicas needs --dir (durable store root)")
        rep = run_replicated_stream(
            directory, replicas=replicas, n_ops=steps * 32,
            readers=max(readers, 1), device=device)
        print(rep.pretty())
        return rep

    cfg = smscc.config(n_vertices=nv, edge_capacity=max(1024, nv),
                       max_probes=64, max_outer=64, max_inner=128)
    svc = SCCService(cfg, buckets=(64, chunk),
                     state=gs.all_singletons(cfg, device),
                     scan_lengths=smscc.SCAN_LENGTHS, proactive_grow=True)
    if readers > 0:
        rep = stream.run_concurrent_stream(
            svc, n_ops=steps * chunk, readers=readers, add_frac=0.7,
            chunk=chunk, n_queries=1024)
    else:
        rep = stream.run_stream(svc, n_ops=steps * chunk, add_frac=0.7,
                                query_frac=0.5, chunk=chunk, n_queries=1024)
    print(rep.pretty())
    return rep


def serve_tenants(steps: int, tenants: int, nv: int = 256,
                  chunk: int = 64, directory: str | None = None,
                  device: str = gs.DEFAULT_DEVICE) -> dict:
    """Multi-tenant serving: N independent session graphs behind ONE
    lane-batched engine and one admission queue
    (:class:`repro_torch.tenancy.MultiTenantService`).  Each tenant runs
    its own typed ``GraphClient`` session on its own thread; concurrent
    submits coalesce into tenant-batched dispatches.  With ``directory``
    the store is durable per tenant (snapshot + WAL).  Returns the
    service's stats with the run's ``wall_s``, ``ops`` and ``final``
    (tenant id -> its last committed (state, gen))."""
    import threading

    from repro_torch.api import SameSCC
    from repro_torch.tenancy import MultiTenantService

    cfg = smscc.config(n_vertices=nv, edge_capacity=max(256, nv),
                       max_probes=64, max_outer=64, max_inner=64)
    mts = MultiTenantService(cfg, buckets=(chunk,),
                             scan_lengths=smscc.SCAN_LENGTHS,
                             directory=directory,
                             coalesce_ops=tenants * chunk,
                             flush_deadline_s=0.005, device=device)
    tids = [mts.create_tenant() for _ in range(tenants)]
    done = []
    errors = []

    def drive(tid, i):
        try:
            client = mts.client(tid)
            rng = np.random.default_rng(100 + i)
            n_ops = 0
            client.submit_many(stream.typed_op_stream(
                nv, chunk, step=0, add_frac=1.0, seed=i,
                include_vertex_ops=True))
            for step in range(steps):
                client.submit_many(stream.typed_op_stream(
                    nv, chunk, step=step + 1, add_frac=0.7, seed=i))
                n_ops += chunk
                qs = [SameSCC(int(a), int(b)) for a, b in
                      zip(rng.integers(0, nv, 16), rng.integers(0, nv, 16))]
                client.submit_many(qs)
            client.close()
            done.append(n_ops)
        except Exception as e:  # re-raised below, on the caller
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=drive, args=(tid, i))
               for i, tid in enumerate(tids)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        mts.close()
        raise errors[0]
    total = sum(done)
    agg = mts.stats()
    print(f"served {tenants} tenants x {steps} chunks "
          f"({total} update ops) in {wall:.2f}s "
          f"({int(total / wall)} ops/s aggregate) on {device}")
    q = agg["queue"]
    print(f"[queue] waves={q['waves']} causes={q['flush_causes']} "
          f"depth_max={q['depth_max_ops']} rejects={q['rejects']} "
          f"pool={q['pool']}")
    e = agg["engine"]
    print(f"[engine] compile_count={e['compile_count']} "
          f"(bound {e['compile_bound']}) solo_replays={e['solo_replays']} "
          f"occupancy={e['occupancy']['frac']}")
    for tid in tids[:4]:
        print(f"[tenant {tid}] " + " | ".join(
            f"{k}={v}" for k, v in mts.tenant_stats(tid).items()
            if k in ("gen", "applied_chunks", "fallback_chunks", "grows",
                     "p50_s", "p95_s")))
    final = {tid: (mts._tenant_state(tid), mts.tenant_gen(tid))
             for tid in tids}
    mts.close()
    agg.update(wall_s=wall, ops=total, final=final)
    return agg


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_lm(cfg: tf.LMConfig, steps: int = 32, *, batch: int = 4,
             prompt_len: int = 12, cache_len: int = 64,
             device: str = gs.DEFAULT_DEVICE, seed: int = 0,
             graph_reps: int = 0) -> Dict:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens: one
    prefill into a ``cache_len`` cache, then ``steps`` greedy decode
    steps.  Weights are random, drawn on ``device`` from a generator seeded
    with ``seed``; so are the prompts, from numpy.

    Returns a report: seconds and tokens/s of prefill (prompt tokens) and
    of decode (generated tokens), the host's seconds per decode step (the
    time to issue a step; the loop never waits on the device), peak device
    bytes (None on the CPU), whether the last logits are finite, and the
    greedy tokens [batch][steps].

    With ``graph_reps`` > 0 on a card, one more decode step is captured in
    a CUDA graph after the timed loop and replayed ``graph_reps`` times
    between CUDA events: ``device_s_per_decode_step`` is the device's time
    for a step with the host's issue cost gone, and
    ``decode_device_share`` that time over the loop's step time (near 1:
    the device bounds decode; far below 1: the host does).  The extra step
    writes the cache's last slot, as a step past the cache does.
    """
    dev = torch.device(device)
    t0 = time.perf_counter()
    params = tf.init(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt_len))
                            .astype(np.int32)).to(dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.perf_counter()
    cache, logits = tf.prefill(params, toks, cfg, cache_len=cache_len)
    tok = logits.argmax(-1).to(torch.int32)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    out, host_s = [], 0.0
    t0 = time.perf_counter()
    for _ in range(steps):
        t_step = time.perf_counter()
        out.append(tok)
        logits, cache = tf.decode_step(params, cache, tok, cfg)
        tok = logits.argmax(-1).to(torch.int32)
        host_s += time.perf_counter() - t_step
    _sync(dev)
    decode_s = time.perf_counter() - t0
    tokens = (torch.stack(out, 1).cpu().tolist() if out
              else [[] for _ in range(batch)])
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    device_step_s = (_graph_step_s(params, cache, tok, cfg, graph_reps)
                     if graph_reps > 0 and dev.type == "cuda" else None)
    return {
        "arch": cfg.name, "device": str(dev), "dtype": str(cfg.dtype),
        "attn_impl": cfg.attn_impl, "n_layers": cfg.n_layers,
        "n_params": cfg.n_params(), "batch": batch,
        "prompt_len": prompt_len, "cache_len": cache_len, "steps": steps,
        "init_s": init_s, "prefill_s": prefill_s,
        "prompt_tok_per_s": batch * prompt_len / prefill_s,
        "decode_s": decode_s,
        "decode_tok_per_s": batch * steps / decode_s if steps else None,
        "host_s_per_decode_step": host_s / steps if steps else None,
        "device_s_per_decode_step": device_step_s,
        "decode_device_share": (device_step_s * steps / decode_s
                                if device_step_s and steps else None),
        "peak_mem_bytes": peak,
        "logits_finite": bool(torch.isfinite(logits).all()),
        "tokens": tokens,
    }


def _graph_step_s(params, cache, tok, cfg: tf.LMConfig, reps: int) -> float:
    """Device seconds of one decode step: the step captured in a CUDA graph
    (after one warm-up step on a side stream) and replayed ``reps`` times
    between CUDA events."""
    def step():  # as the serving loop's step: decode, then greedy pick
        tf.decode_step(params, cache, tok, cfg)[0].argmax(-1).to(torch.int32)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps / 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smscc")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--device", default=gs.DEFAULT_DEVICE)
    ap.add_argument("--readers", type=int, default=0,
                    help="smscc only: concurrent reader threads (0 = "
                         "serial query interleaving)")
    ap.add_argument("--replicas", type=int, default=0,
                    help="smscc only: serve reads from N WAL-tailing "
                         "replicas over a durable writer (needs --dir)")
    ap.add_argument("--dir", dest="directory", default=None,
                    help="smscc only: durable store root for --replicas "
                         "or --tenants")
    ap.add_argument("--tenants", type=int, default=0,
                    help="smscc only: serve N tenants' graphs behind one "
                         "lane-batched engine")
    args = ap.parse_args()
    mod = configs.get(args.arch)
    if mod.FAMILY == "lm":
        rep = serve_lm(mod.smoke_config(), args.steps, device=args.device)
        print(f"prefill {rep['batch']} x {rep['prompt_len']} tokens in "
              f"{rep['prefill_s']:.3f}s; decoded {rep['steps']} tokens x "
              f"batch {rep['batch']} in {rep['decode_s']:.3f}s "
              f"({rep['decode_tok_per_s']} tok/s) on {rep['device']}")
        print("sample:", rep["tokens"][0][:16])
    elif args.tenants > 0:
        serve_tenants(args.steps, args.tenants, directory=args.directory,
                      device=args.device)
    else:
        serve_smscc(args.steps, readers=args.readers,
                    replicas=args.replicas, directory=args.directory,
                    device=args.device)


if __name__ == "__main__":
    main()
