#!/usr/bin/env python3
"""Where an SMSCC update step's time goes on the card: one of
``chip_smoke.py``'s serving cells through ``launch.stream.run_stream``,
three times as ``chip_smoke.py`` runs it and once under
``torch.profiler``.

    PYTHONPATH=src python scripts/profile_smscc_torch.py
    python scripts/profile_smscc_torch.py --cell dense_tier
    python scripts/profile_smscc_torch.py --tree build/parent   # another
                                                                # checkout

``--cell`` names an entry of ``chip_smoke.SERVE_CELLS`` in this checkout:
``update_1m`` (phase 3, the main path: 2^20 vertices, a 2^23-slot table
preloaded with 2^21 random edges, 8 chunks of 32768 ops of the paper's
mix with SameSCC and Reachable batches between them) or ``dense_tier``
(phase 4: 2^14 vertices, a 2^16-slot table, dense_capacity 512, 8 chunks
of 1024 ops).  ``--tree`` names the root of a checkout whose
``src/repro_torch`` and ``chip_smoke.serve_path`` are used (default: this
one), so two versions can be compared on one card in turns, each in its
own process, on the same cell.  The tree's kernels are built first.
Each of the three runs reports update
ops/s, host syncs and launches a step, and the fixpoint rounds where the
tree counts them.  The profiled run boots the same graph again and runs
the cell's update chunks alone (no queries): wall and device-busy seconds
a step, the idle share, the host's calls that put work on the card a
step (kernel launches, graph replays, copies, fills; by name), the device
seconds of each kernel family (the fixpoint launch, the round gather, the
edge table's kernels, the rest) and the costliest kernels.  A last run
of the whole cell goes under cProfile: the host seconds a chunk of the
functions that take the most own time.  Prints one JSON object, then the
card's name and power limit.  Needs a CUDA card: without one it exits 1.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

from device_profile import profiled

HERE = Path(__file__).resolve().parents[1]
REPEATS = 3
FAMILIES = (
    ("fixpoint", ("fixpoint_rounds", "scc_rounds")),
    ("round_gather", ("gather_rows",)),
    ("edge_table", ("insert_rounds", "remove_first", "probe_walk")),
    ("index_gather_scatter", ("index", "scatter", "gather")),
    ("sort_scan", ("sort", "scan", "cumsum", "radix")),
    ("copy_fill", ("copy", "fill")),
)
KEEP = ("ops_per_s", "queries_per_s", "steps", "update_s",
        "update_host_syncs_per_step", "update_launches_per_step",
        "query_syncs", "query_launches", "fixpoint_launches",
        "fixpoint_rounds", "frontier_rounds_per_step",
        "trim_rounds_per_step", "query_rounds", "repair_steps",
        "step_graph", "peak_mem_bytes")


def chip_smoke_of(root: Path, name: str):
    """The ``chip_smoke.py`` of the checkout at ``root`` as module
    ``name``; importing it puts that checkout's ``src`` first on
    ``sys.path``."""
    spec = importlib.util.spec_from_file_location(name,
                                                  root / "chip_smoke.py")
    mod = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_profiled(fn, top: int = 12) -> dict:
    """One more run of ``fn`` under cProfile: the host seconds of the
    ``top`` functions by own time ("file:line function")."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.runcall(fn)
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return {f"{Path(f).name}:{line} {name}": tt
            for (f, line, name), (_, _, tt, _, _) in rows}


def main() -> int:
    here = chip_smoke_of(HERE, "chip_smoke")
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="update_1m",
                    choices=sorted(here.SERVE_CELLS))
    ap.add_argument("--tree", default=str(HERE))
    args = ap.parse_args()
    root = Path(args.tree).resolve()
    cell = here.SERVE_CELLS[args.cell]
    # the tree's chip_smoke, imported last, puts its src first
    cs = here if root == HERE else chip_smoke_of(root, "chip_smoke_tree")

    import torch
    if not torch.cuda.is_available():
        print("profile_smscc_torch: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import smscc
    from repro_torch.core.service import SCCService
    from repro_torch.kernels import _build
    from repro_torch.launch import stream

    dev = torch.device("cuda")
    _build.build()  # every kernel, before any timed run
    out = {"tree": str(root), "cell": args.cell, "runs": []}
    for _ in range(REPEATS):
        rep, _ = cs.serve_path(torch, dev, **cell)
        out["runs"].append({k: rep[k] for k in KEEP if k in rep})
        torch.cuda.empty_cache()

    cfg = smscc.config(n_vertices=cell["nv"], edge_capacity=cell["cap"],
                       dense_capacity=cell.get("dense_capacity", 0))
    state, _ = cs.boot_state(torch, dev, cfg, cell["preload_deg"])
    svc = SCCService(cfg, buckets=(cell["bucket"],), state=state,
                     scan_lengths=smscc.SCAN_LENGTHS, proactive_grow=True)
    run = {}

    def updates():
        run.update(stream.run_stream(
            svc, cell["n_chunks"] * cell["chunk"], add_frac=0.7,
            chunk=cell["chunk"], seed=cs.SEED))

    prof = profiled(torch, updates, FAMILIES, top=8)
    host = host_profiled(lambda: cs.serve_path(torch, dev, **cell))
    steps = sum(run[f"repair_{t}_steps"] for t in
                ("dense", "compact", "full", "skipped"))
    out["profiled"] = {
        "steps": steps, "wall_s_per_step": prof["wall_s"] / steps,
        "device_busy_s_per_step": prof["device_busy_s"] / steps,
        "device_idle_share": prof["device_idle_share"],
        "kernels_per_step": prof["kernels"] / steps,
        "host_issue_calls_per_step": sum(
            prof["host_issue_calls"].values()) / steps,
        "host_issue_calls": prof["host_issue_calls"],
        "host_syncs_per_step": run["update_syncs"] / steps,
        "device_s_per_step_by_family": {
            k: v / steps for k, v in prof["device_s_by_family"].items()},
        "top_kernels_s": prof["top_kernels_s"]}
    out["host_s_per_chunk_by_function"] = {
        k: v / cell["n_chunks"] for k, v in host.items()}
    print(json.dumps(out), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
