"""LM training on the PyTorch/CUDA port, as examples/train_lm.py runs it on
the JAX package: a reduced qwen3-style model end to end (data pipeline ->
train step -> checkpoint -> loss curve), 60 steps.  Its checkpoints go to a
temporary directory of its own, removed at the end.

    PYTHONPATH=src python examples/train_lm_torch.py                # card
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu
"""
import argparse
import dataclasses
import tempfile

import torch

from repro_torch import configs
from repro_torch.core import graph_state as gs
from repro_torch.launch.train import _lm_setup
from repro_torch.optim import optimizer
from repro_torch.train import trainer
from repro_torch.tree import tree_leaves


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=gs.DEFAULT_DEVICE)
    dev = torch.device(ap.parse_args().device)
    smoke = configs.get("qwen3-14b").smoke_config()
    cfg = dataclasses.replace(smoke, n_layers=2, d_model=64, vocab=512)
    params, loss_fn, data_fn = _lm_setup(cfg, 16, 64, dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"training {cfg.name}: {n_params:,} params")

    with tempfile.TemporaryDirectory(prefix="lm_ckpt_torch_") as ckpt:
        t = trainer.Trainer(
            loss_fn, params,
            optimizer.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=60),
            trainer.TrainerConfig(total_steps=60, ckpt_dir=ckpt,
                                  ckpt_every=25, log_every=10),
            data_fn)
        log = t.run()
    print("loss curve:")
    for step, m in log:
        print(f"  step {step:3d}  loss {m['loss']:.3f}  "
              f"ce {m.get('ce', m['loss']):.3f}  lr {m['lr']:.2e}")
    first, last = log[0][1]["loss"], log[-1][1]["loss"]
    if not last < first:
        raise SystemExit("loss did not decrease")
    print(f"loss {first:.2f} -> {last:.2f}  "
          f"(stragglers flagged: {t.straggler_events})")


if __name__ == "__main__":
    main()
