"""Training driver for the port, as ``repro.launch.train``.

    python -m repro_torch.launch.train --arch qwen3-14b --smoke --steps 4
    python -m repro_torch.launch.train --arch mind --smoke --steps 4 \\
        --device cpu
    python -m repro_torch.launch.train --arch moonshot-v1-16b-a3b --smoke \\
        --steps 8 --ckpt-dir /tmp/ckpt --compress-grads
    python -m repro_torch.launch.train --arch egnn --smoke --steps 4 \\
        --device cpu

An LM arch trains on ``lm_batch`` streams (16 x 64 tokens with --smoke,
else the reference's 256 x 4096 at the arch's full config), a GNN arch
(egnn, gatedgcn, nequip, mace) on one node-classification graph (200
nodes and 1000 edges with --smoke, else 4096 and 32768 with 64 features),
``--arch mind`` on ``mind_batch`` streams (64 users with --smoke, else
65536), with the reference launcher's AdamW settings; a checkpoint every
quarter of the run goes to ``--ckpt-dir``, from which a rerun resumes.
Without --smoke the full config runs, as the reference's does off the
CPU.  The weights are random (a seeded generator).  Runs on ``cuda``
unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs
from repro_torch.core import graph_state as gs
from repro_torch.data import pipeline
from repro_torch.optim import optimizer
from repro_torch.train import trainer


def _lm_setup(cfg, batch: int, seq: int, device, seed: int = 0):
    """(params, loss_fn, data_fn) of an LM config: random weights from
    ``seed`` on ``device``, batches of ``batch`` x ``seq`` tokens."""
    from repro_torch.models import transformer as tf
    params = tf.init(cfg, torch.Generator(device).manual_seed(seed), device)

    def loss_fn(p, b):
        return tf.loss_fn(p, b, cfg)

    def data_fn(step):
        return pipeline.lm_batch(cfg.vocab, batch, seq, step=step,
                                 device=device)

    return params, loss_fn, data_fn


def _mind_setup(cfg, batch: int, device, seed: int = 0):
    """(params, loss_fn, data_fn) of a MIND config: random weights from
    ``seed`` on ``device``, batches of ``batch`` users."""
    from repro_torch.models.recsys import mind
    params = mind.init(cfg, torch.Generator(device).manual_seed(seed),
                       device)

    def loss_fn(p, b):
        return mind.loss_fn(p, b, cfg)

    def data_fn(step):
        return pipeline.mind_batch(cfg.n_items, batch, cfg.seq_len,
                                   cfg.profile_vocab, cfg.profile_len,
                                   cfg.n_neg, step=step, device=device)

    return params, loss_fn, data_fn


def _gnn_setup(mod, smoke: bool, device, seed: int = 0):
    """(params, loss_fn, data_fn) of a GNN arch as the reference launcher
    sets it up: node classification over 7 classes on one fixed
    ``node_class_graph``; random weights from ``seed`` on ``device``."""
    model = mod.MODULE
    cfg = mod.smoke_config(task="node_class", n_classes=7) if smoke \
        else mod.config(task="node_class", n_classes=7, d_feat=64)
    graph = pipeline.node_class_graph(
        200 if smoke else 4096, 1000 if smoke else 32768,
        cfg.d_feat, cfg.n_classes, seed=0, device=device)
    params = model.init(cfg, torch.Generator(device).manual_seed(seed),
                        device)

    def loss_fn(p, b):
        return model.loss_fn(p, b, cfg)

    return params, loss_fn, lambda step: graph


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--smoke", action="store_true", default=None)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=gs.DEFAULT_DEVICE)
    args = ap.parse_args()
    device = torch.device(args.device)
    # the reference trains the smoke config by default on the CPU
    smoke = args.smoke if args.smoke is not None else device.type == "cpu"
    mod = configs.get(args.arch)
    if mod.FAMILY == "smscc":
        raise SystemExit("use examples/dynamic_scc_serving_torch.py for "
                         "smscc")
    cfg = mod.smoke_config() if smoke else mod.config()
    if mod.FAMILY == "lm":
        batch, seq = (16, 64) if smoke else (256, 4096)
        params, loss_fn, data_fn = _lm_setup(cfg, batch, seq, device)
    elif mod.FAMILY == "gnn":
        params, loss_fn, data_fn = _gnn_setup(mod, smoke, device)
    else:  # recsys
        params, loss_fn, data_fn = _mind_setup(
            cfg, 64 if smoke else 65536, device)
    t = trainer.Trainer(
        loss_fn, params,
        optimizer.AdamWConfig(lr=1e-3, warmup_steps=10,
                              total_steps=args.steps),
        trainer.TrainerConfig(
            total_steps=args.steps, ckpt_dir=args.ckpt_dir,
            ckpt_every=max(args.steps // 4, 1), log_every=10,
            grad_compression=args.compress_grads),
        data_fn)
    log = t.run()
    for step, m in log:
        print(f"step {step:4d}  loss {m['loss']:.4f}")
    print(f"done: {len(t.step_times)} steps, "
          f"median {sorted(t.step_times)[len(t.step_times)//2]*1e3:.0f}"
          f"ms/step, stragglers={t.straggler_events} on {device}")


if __name__ == "__main__":
    main()
