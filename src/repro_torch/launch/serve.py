"""Serving driver for the port: the paper's streaming SCC service.

    python -m repro_torch.launch.serve --steps 64
    python -m repro_torch.launch.serve --steps 8 --device cpu

A typed GraphClient update stream with SameSCC / Reachable query batches
between chunks, over an SCCService booted with every vertex slot live.
Runs on ``cuda`` unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import smscc
from repro_torch.core import graph_state as gs
from repro_torch.core.service import SCCService
from repro_torch.launch import stream


def serve_smscc(steps: int, nv: int = 2048, chunk: int = 256,
                device: str = gs.DEFAULT_DEVICE) -> stream.StreamReport:
    cfg = smscc.config(n_vertices=nv, edge_capacity=max(1024, nv),
                       max_probes=64, max_outer=64, max_inner=128)
    svc = SCCService(cfg, buckets=(64, chunk),
                     state=gs.all_singletons(cfg, device),
                     scan_lengths=smscc.SCAN_LENGTHS, proactive_grow=True)
    rep = stream.run_stream(svc, n_ops=steps * chunk, add_frac=0.7,
                            query_frac=0.5, chunk=chunk, n_queries=1024)
    print(rep.pretty())
    return rep


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--device", default=gs.DEFAULT_DEVICE)
    args = ap.parse_args()
    serve_smscc(args.steps, device=args.device)


if __name__ == "__main__":
    main()
