"""Fault-tolerant training loop, as ``repro.train.trainer``.

  * **checkpoint/restart**: the full step state -- params, AdamW moments,
    error-feedback residuals, the seed (``rng``) -- is saved atomically
    every ``ckpt_every`` steps under the step it reached (the data
    cursor); on construction the trainer restores the latest intact
    checkpoint and resumes at its step.  The data pipeline is a pure
    function of the step, so a preempted-and-resumed run is bit-identical
    to an uninterrupted one.
  * **straggler surveillance**: per-step wall time against a rolling
    median; steps beyond ``straggler_factor`` x the median are counted.
  * **gradient compression**: optional int8 error feedback on the
    gradients (``optim/compression.py``), averaged over ``pod_axis`` of
    the current mesh when one is named.
  * **in place**: the update writes the params and moments in place (the
    reference donates their buffers to its jitted step).

A step reads one value back to the host, its loss (the reference's
``block_until_ready``); the other metrics are read at log steps only.
``step_times`` start after ``data_fn`` returns, so they exclude making the
batch, as the reference's do.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.ckpt import checkpoint
from repro_torch.optim import compression, optimizer
from repro_torch.tree import tree_leaves, tree_unflatten


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 20
    keep_ckpts: int = 3
    log_every: int = 10
    grad_compression: bool = False
    pod_axis: Optional[str] = None  # axis name for the compressed psum
    straggler_factor: float = 3.0


class Trainer:
    def __init__(self, loss_fn: Callable, params,
                 opt_cfg: optimizer.AdamWConfig, cfg: TrainerConfig,
                 data_fn: Callable[[int], dict]):
        """loss_fn(params, batch) -> (loss, metrics); data_fn(step) ->
        batch.  ``params`` is taken over: the trainer updates it in
        place."""
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.data_fn = data_fn
        self.loss_fn = loss_fn
        self.state = {
            "params": params,
            "opt": optimizer.init(params),
            "ef": (compression.init(params)
                   if cfg.grad_compression else None),
            "rng": torch.zeros((), dtype=torch.int64),
        }
        self.step = 0
        self.metrics_log = []
        self.step_times = []
        self.straggler_events = 0
        self._maybe_restore()

    def value_and_grad(self, params, batch):
        """(loss, metrics, grads) at ``params``: the step's forward and
        backward, with every leaf differentiated (an unused one gets
        zeros, as ``jax.grad`` gives it)."""
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        loss, metrics = self.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_unflatten(params, grads))

    def train_step(self, state, batch):
        loss, metrics, grads = self.value_and_grad(state["params"], batch)
        ef = state["ef"]
        if ef is not None:
            grads, ef = compression.compressed_psum(grads, ef,
                                                    self.cfg.pod_axis)
        params, opt, m2 = optimizer.update(grads, state["opt"],
                                           state["params"], self.opt_cfg)
        metrics = dict(metrics, loss=loss, **m2)
        return {"params": params, "opt": opt, "ef": ef,
                "rng": state["rng"] + 1}, metrics

    def _maybe_restore(self):
        if self.cfg.ckpt_dir is None:
            return
        restored, step = checkpoint.restore(self.cfg.ckpt_dir, self.state)
        if restored is not None:
            self.state = restored
            self.step = int(step)

    def save(self):
        if self.cfg.ckpt_dir is not None:
            checkpoint.save(self.cfg.ckpt_dir, self.step, self.state,
                            keep=self.cfg.keep_ckpts)

    def _watch_straggler(self, dt: float):
        self.step_times.append(dt)
        hist = self.step_times[-50:]
        if len(hist) >= 10:
            med = sorted(hist)[len(hist) // 2]
            if dt > self.cfg.straggler_factor * med:
                self.straggler_events += 1

    def run(self, steps: Optional[int] = None):
        end = self.step + steps if steps is not None else \
            self.cfg.total_steps
        while self.step < end:
            batch = self.data_fn(self.step)
            t0 = time.perf_counter()
            self.state, metrics = self.train_step(self.state, batch)
            metrics["loss"] = metrics["loss"].item()  # the step's host read
            self._watch_straggler(time.perf_counter() - t0)
            self.step += 1
            if self.step % self.cfg.log_every == 0 or self.step == end:
                self.metrics_log.append(
                    (self.step, {k: float(v) for k, v in metrics.items()}))
            if self.cfg.ckpt_dir is not None and \
                    self.step % self.cfg.ckpt_every == 0:
                self.save()
        return self.metrics_log
