#!/usr/bin/env python3
"""Where a fixpoint launch's time goes on the card, part by part.

    PYTHONPATH=src python scripts/profile_fixpoint_torch.py
    python scripts/profile_fixpoint_torch.py --tree build/parent  # another
                                                                  # checkout

Runs every case of ``chip_smoke.fixpoint_checks`` (the boolean sweep, at
its cap and at 3 rounds, the FW/BW pair, labels with and without pointer
doubling, priorities, the packed Reachable batch, trim) and the scc form
(min labels, priorities) on ``chip_smoke.fixpoint_graphs``: update_1m's
preloaded graph (2^20 vertices, 2^23 slots, 2^21 live edges) and 256
tenant lanes at the tenant path's class-A shape (4096 vertices, 2^14
slots).  For each case, ``chip_smoke.part_rows``: one launch with part
stamps (``ops.frontier_fixpoint(..., stamps=)``: one %globaltimer record
a grid barrier, null on every main-path call), its state and rounds equal
to an unstamped launch's, gives the grid, the blocks an SM and each
pass's time with its barrier wait (the edge pass, the vertex pass, the
hop pass, the compaction pass).  Beside them: the rounds by form the card
counted and the device time of the launch from a replayed CUDA graph.

``--tree`` names the root of a checkout whose ``src/repro_torch`` and
``chip_smoke`` are used (default: this one; it must have part stamps,
as this design has), so two versions can be run on one card in turns,
each in its own process.  ``--where`` picks one of
the two graphs.  Prints one JSON object a case, then the kernel's
registers and spills as ``nvcc -Xptxas -v`` gave them, then the card's
name and power limit.  Needs a CUDA card: without one it exits 1.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from profile_smscc_torch import chip_smoke_of

HERE = Path(__file__).resolve().parents[1]


def cases(torch, cs, dev, st, max_inner, max_outer):
    """(tag, form, shortcut, launch) of every case on one graph state:
    ``launch(**probe)`` runs the fixpoint and returns (state, rounds)."""
    from repro_torch.core.edge_table import LIVE
    from repro_torch.kernels.frontier_expand import ops as fops

    src, dst, live = st.edges.src, st.edges.dst, st.edges.state == LIVE
    allowed = st.v_alive
    vid = torch.arange(allowed.shape[-1], dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    out = []
    for tag, form, shortcut, mask, init, it in cs._fix_cases(
            torch, dev, g, allowed, vid, max_inner):
        def launch(m=mask, i=init, f=form, sc=shortcut, c=it, **probe):
            return fops.frontier_fixpoint(f, src, dst, live, m, i, c,
                                          shortcut=sc, vid=vid, **probe)
        out.append((tag, form, shortcut, launch))
    for shortcut in (False, True):
        def launch(sc=shortcut, **probe):
            return fops.frontier_fixpoint("scc", src, dst, live, allowed,
                                          None, max_inner, shortcut=sc,
                                          max_outer=max_outer, **probe)
        out.append(("scc" + (", shortcut" if shortcut else ""), "scc",
                    shortcut, launch))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--where", choices=("update_1m", "lanes"), default=None)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    root = Path(args.tree).resolve()
    cs = chip_smoke_of(root, "chip_smoke_tree")

    import torch
    if not torch.cuda.is_available():
        print("profile_fixpoint_torch: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import smscc
    from repro_torch.kernels import _build
    from repro_torch.kernels.frontier_expand import ops as fops

    dev = torch.device("cuda")
    _build.build(["frontier_min", "hash_probe"])
    cfg = smscc.config()
    for where, st in cs.fixpoint_graphs(torch, dev):
        if args.where and not where.startswith(args.where):
            continue
        for tag, form, shortcut, launch in cases(
                torch, cs, dev, st, cfg.max_inner, cfg.max_outer):
            want = launch()
            row = cs.part_rows(torch, launch, want, where, tag)
            by_form = {k: n for k, n in fops.fixpoint_rounds().items() if n}
            print(json.dumps(dict(
                tree=str(root), where=where, case=tag, form=form,
                shortcut=shortcut, rounds=want[1].tolist(),
                rounds_by_form=by_form, **row,
                ms=cs.graph_ms(torch, launch, args.reps))), flush=True)
            del want
        del st
        torch.cuda.empty_cache()
    print(json.dumps({"tree": str(root), "ptxas": _build.build_log.get(
        "frontier_min", (None, []))[1]}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
