#!/usr/bin/env python3
"""Where an LM's serving time goes on the card: one prefill and a few
decode steps of the port's LM (``repro_torch.models.transformer``) under
``torch.profiler``, the device time summed by kernel family.

    PYTHONPATH=src python scripts/profile_lm_torch.py \
        --arch moonshot-v1-16b-a3b
    PYTHONPATH=src python scripts/profile_lm_torch.py \
        --arch qwen3-moe-235b-a22b --layers 4

4 requests of 4096 prompt tokens, then 4 decode steps (the LM path of
``chip_smoke.py``).  Weights are random (a seeded generator on the
card).  A warm-up prefill of 128 tokens and one decode step run first,
unprofiled.  Prints one JSON
object per window (``prefill``, ``decode``): the window's wall seconds
(host clock to a synchronise), the device's busy seconds (the sum of the
kernels' device times; one stream, so they do not overlap) and its idle
share, the device seconds of each kernel family (flash attention, matmul,
index gather/scatter, cumsum, sort/top-k, copies and casts, other
elementwise) and the ten costliest kernels; then the card's name and
power limit.  Needs a CUDA card: without one it exits 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from device_profile import profiled  # noqa: E402

# kernel family by a substring of the kernel's name, first match wins
FAMILIES = (
    ("flash_attention", ("flash_wgmma", "flash_fma")),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "cublas")),
    ("sort_topk", ("sort", "topk", "radix", "bitonic")),
    ("cumsum", ("scan", "cumsum")),
    ("index_gather_scatter", ("index", "scatter", "gather")),
    ("copy_cast", ("copy", "fill", "cast")),
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="moonshot-v1-16b-a3b")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: full)")
    args = ap.parse_args()
    batch, prompt, steps = 4, 4096, 4

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_lm_torch: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch import configs
    from repro_torch.models import transformer as tf

    dev = torch.device("cuda")
    cfg = configs.get(args.arch).config(attn_impl="flash")
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = tf.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (batch, prompt)).astype(np.int32)).to(dev)
    cache_len = prompt + steps + 1

    # warm-up: cuBLAS handles, the kernels' build and first launches
    cache, logits = tf.prefill(params, toks[:, :128], cfg, cache_len=136)
    tf.decode_step(params, cache, logits.argmax(-1).to(torch.int32), cfg)
    del cache
    torch.cuda.synchronize()

    state = {}

    def prefill():
        state["cache"], state["logits"] = tf.prefill(params, toks, cfg,
                                                     cache_len=cache_len)

    def decode():
        tok = state["logits"].argmax(-1).to(torch.int32)
        for _ in range(steps):
            logits, state["cache"] = tf.decode_step(params, state["cache"],
                                                    tok, cfg)
            tok = logits.argmax(-1).to(torch.int32)

    head = {"arch": cfg.name, "n_layers": cfg.n_layers, "batch": batch,
            "prompt": prompt}
    print(json.dumps({"window": "prefill", **head,
                      **profiled(torch, prefill, FAMILIES)}), flush=True)
    print(json.dumps({"window": "decode", **head, "steps": steps,
                      **profiled(torch, decode, FAMILIES)}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
