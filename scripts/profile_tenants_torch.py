#!/usr/bin/env python3
"""Tenant-lane serving on the card: ``chip_smoke.py`` phase 10's class A
alone (T tenants of 4096 vertices and 2^14 slots, each preloaded with
out-degree-2 random edges), ``--waves`` waves of one 1024-op chunk per
tenant of the paper's mix through a ``TenantEngine``, three times as
phase 10 runs them and once under ``torch.profiler``.

    PYTHONPATH=src python scripts/profile_tenants_torch.py
    python scripts/profile_tenants_torch.py --tenants 8
    python scripts/profile_tenants_torch.py --tree build/parent   # another
                                                                  # checkout

``--tree`` names the root of a checkout whose ``src/repro_torch`` and
``chip_smoke.{boot_lanes,tenant_ops}`` are used (default: this one), so
two versions can be compared on one card in turns, each in its own
process.  The tree's kernels are built first.  Each run reports update
ops/s (the waves' ops over their wall, each wave ending in a
synchronise), host syncs a wave, frontier_min's launches (all, the
tenant-row forms, the fixpoint launches, the scc form's), the fixpoint
rounds by form, the lane steps of each repair tier and the step graphs
captured.  The profiled run: wall and device-busy seconds a wave, the
idle share, the host's calls that issue work, device seconds by kernel
family and the costliest kernels.  Prints one JSON object, then the
card's name and power limit.  Needs a CUDA card: without one it exits 1.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

from device_profile import profiled
from profile_smscc_torch import FAMILIES, chip_smoke_of

HERE = Path(__file__).resolve().parents[1]
REPEATS = 3
NV, CAP, CHUNK = 4096, 2 ** 14, 1024


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tenants", type=int, default=256)
    ap.add_argument("--waves", type=int, default=8)
    ap.add_argument("--tree", default=str(HERE))
    args = ap.parse_args()
    root = Path(args.tree).resolve()
    cs = chip_smoke_of(root, "chip_smoke_tree")  # its src first

    import torch
    if not torch.cuda.is_available():
        print("profile_tenants_torch: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch import kernels
    from repro_torch.configs import smscc
    from repro_torch.core import graph_state as gs
    from repro_torch.core import step_graph
    from repro_torch.core.sync import SYNCS
    from repro_torch.kernels import _build
    from repro_torch.kernels.frontier_expand import ops as fops
    from repro_torch.tenancy import TenantEngine

    dev = torch.device("cuda")
    _build.build()  # every kernel, before any timed run
    fm = fops.frontier_min
    counted = hasattr(fm, "scc_launches")
    if not counted:  # a tree from before the counter: its launches are
        calls = [0]  # its calls (it captures no lane step)
        launch = fops._scc_launch

        def counting(*a, **kw):
            calls[0] += 1
            return launch(*a, **kw)
        fops._scc_launch = counting

    cfg = smscc.config(n_vertices=NV, edge_capacity=CAP)
    n = args.tenants
    boot, _, _ = cs.boot_lanes(torch, dev, cfg, n, 2, cs.SEED)
    ops = [cs.tenant_ops(NV, CHUNK, args.waves, cs.SEED + 1000 + i)
           for i in range(n)]
    tids = [f"a{i}" for i in range(n)]

    def engine():
        eng = TenantEngine(buckets=(CHUNK,), tenant_batches=(1, 8, 64, 256),
                           device=dev)
        for i, tid in enumerate(tids):
            eng.create_tenant(tid, cfg, state=gs.lane(boot, i), gen=1)
        return eng

    def waves(eng, walls=None, syncs=None):
        for w in range(args.waves):
            s0, t0 = SYNCS.count, time.perf_counter()
            eng.apply_chunks([(tid, *ops[i][w])
                              for i, tid in enumerate(tids)])
            step_graph.synchronize(dev)
            if walls is not None:
                walls.append(time.perf_counter() - t0)
                syncs.append(SYNCS.count - s0)

    out = {"tree": str(root), "tenants": n, "waves": args.waves,
           "chunk": CHUNK, "runs": []}
    for _ in range(REPEATS):
        eng = engine()
        kernels.reset_launch_counts()
        if not counted:
            calls[0] = 0
        captures = step_graph.captures
        walls, syncs = [], []
        waves(eng, walls, syncs)
        launches = kernels.launch_counts()["frontier_min"]
        st = eng.stats()
        out["runs"].append({
            "ops_per_s": n * args.waves * CHUNK / sum(walls),
            "wave_s": walls, "host_syncs_per_wave": sum(syncs) / args.waves,
            "frontier_min_launches": launches,
            "lane_launches": fm.lane_launches,
            "fixpoint_launches": fm.fixpoint_launches,
            "scc_launches": fm.scc_launches if counted else calls[0],
            "fixpoint_rounds": fops.fixpoint_rounds(),
            "repair_lane_steps": st["repair_lane_steps"],
            "solo_replays": st["solo_replays"],
            "step_graph_captures": step_graph.captures - captures})
        del eng
        torch.cuda.empty_cache()

    eng = engine()
    prof = profiled(torch, lambda: waves(eng), FAMILIES, top=8)
    w = args.waves
    out["profiled"] = {
        "wall_s_per_wave": prof["wall_s"] / w,
        "device_busy_s_per_wave": prof["device_busy_s"] / w,
        "device_idle_share": prof["device_idle_share"],
        "kernels_per_wave": prof["kernels"] / w,
        "host_issue_calls_per_wave": sum(
            prof["host_issue_calls"].values()) / w,
        "device_s_per_wave_by_family": {
            k: v / w for k, v in prof["device_s_by_family"].items()},
        "top_kernels_s": prof["top_kernels_s"]}
    print(json.dumps(out), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
