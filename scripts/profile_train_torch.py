#!/usr/bin/env python3
"""Where a training step's time goes on the card: one step of the port's
Trainer (forward, backward, AdamW) under ``torch.profiler``, the device
time summed by kernel family.

    PYTHONPATH=src python scripts/profile_train_torch.py --arch qwen3-14b
    PYTHONPATH=src python scripts/profile_train_torch.py --arch mind
    PYTHONPATH=src python scripts/profile_train_torch.py --arch mind \\
        --gather index
    PYTHONPATH=src python scripts/profile_train_torch.py --arch nequip \\
        --shape minibatch_lg

The cells of ``chip_smoke.py``'s training phases: qwen3-14b at full width
and 4 layers (bf16, chunked attention, remat full, 2 x 4096 tokens),
MIND's full config at 65536 users, or a GNN (egnn, gatedgcn, nequip,
mace) at its published config on one of the reference's GNN shapes
(``--shape``, default minibatch_lg; chip_smoke's data, remat on, TF32
off).  ``--gather index`` times MIND with its item rows gathered by
``table[ids]`` instead of ``F.embedding``, for comparison.  Weights are
random (a seeded generator on the card).  One step runs first,
unprofiled.  Prints one JSON object (wall seconds to a synchronise, the
device's busy seconds and idle share, device seconds by kernel family,
the ten costliest kernels), then the card's name and power limit.  Needs
a CUDA card: without one it exits 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(ROOT))
GNN_ARCHS = ("egnn", "gatedgcn", "nequip", "mace")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b",
                    choices=("qwen3-14b", "mind") + GNN_ARCHS)
    ap.add_argument("--shape", default="minibatch_lg",
                    choices=("molecule", "full_graph_sm", "minibatch_lg",
                             "ogb_products"))
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--gather", default="embedding",
                    choices=("embedding", "index"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_train_torch: needs a CUDA card", file=sys.stderr)
        return 1
    from device_profile import profiled
    from profile_lm_torch import FAMILIES
    from repro_torch import configs
    from repro_torch.launch import train as ltrain
    from repro_torch.models.recsys import mind
    from repro_torch.optim import optimizer
    from repro_torch.train import trainer

    dev = torch.device("cuda")
    if args.arch == "mind":
        cfg = configs.get("mind").config()
        setup = ltrain._mind_setup(cfg, 65536, dev)
        head = {"arch": "mind", "batch": 65536, "gather": args.gather}
        if args.gather == "index":
            mind._rows = lambda table, ids: table[ids.long()]
    elif args.arch in GNN_ARCHS:
        import chip_smoke
        from repro_torch.configs import gnn_shapes

        torch.backends.cuda.matmul.allow_tf32 = False
        shape = gnn_shapes.gnn_shapes()[args.shape]
        data = chip_smoke.gnn_shape_data(torch, dev, args.shape, shape)
        mod = configs.get(args.arch)
        cfg = chip_smoke.gnn_full_config(mod, shape, **data["cfg_kw"])
        params = mod.MODULE.init(cfg, torch.Generator(dev).manual_seed(0),
                                 dev)
        setup = (params, lambda p, b: mod.MODULE.loss_fn(p, b, cfg),
                 data["data_fn"])
        head = {"arch": args.arch, "shape": args.shape,
                "n_nodes": data["n_nodes"], "n_edges": data["n_edges"]}
    else:
        cfg = dataclasses.replace(configs.get(args.arch).config(
            attn_impl="chunked", remat="full"), n_layers=args.layers)
        setup = ltrain._lm_setup(cfg, 2, 4096, dev)
        head = {"arch": cfg.name, "n_layers": cfg.n_layers, "batch": 2,
                "seq": 4096}
    params, loss_fn, data_fn = setup
    t = trainer.Trainer(loss_fn, params,
                        optimizer.AdamWConfig(lr=1e-3, warmup_steps=10,
                                              total_steps=2),
                        trainer.TrainerConfig(total_steps=2), data_fn)
    batches = [data_fn(0), data_fn(1)]

    def step(i):
        t.state, metrics = t.train_step(t.state, batches[i])
        metrics["loss"].item()

    step(0)  # warm-up: cuBLAS handles, the kernels' build
    prof = profiled(torch, lambda: step(1), FAMILIES)
    print(json.dumps({"window": "train_step", **head, **prof}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
