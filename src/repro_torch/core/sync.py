"""Counted host synchronisations.

JAX keeps the fixpoint loops, the repair gate and the tier dispatch on the
device (``lax.while_loop`` / ``lax.cond``).  So does the port on the card:
each fixpoint, and the static SCC with its outer loop, is one kernel
launch that loops on the device, and the update step is one replay of a
captured CUDA graph whose repair gate and tier choice are conditional
nodes (``core/step_graph.py``), so a step reads nothing back.  On CPU
tensors and DTensors over a mesh the step runs eagerly and each decision
reads one value back: the repair gate, the region sizes for the tier
choice, each outer round of the static SCC and each fixpoint round (the
per-round loop); so does ``dynamic.apply_batch_stats_eager`` on the card.
Every such read goes through :data:`SYNCS`, so a run can report how many
host syncs a step costs.  The service's one deferred read of a
super-chunk's outputs is not a decision inside a step and is not counted.
"""
from __future__ import annotations

import threading
from typing import List

import torch


class SyncCounter:
    """Counts device-to-host reads that steer control flow (the update
    thread and a broker's dispatcher thread may both read)."""

    def __init__(self):
        self.count = 0
        self._lock = threading.Lock()

    def _tick(self):
        with self._lock:
            self.count += 1

    def bool(self, t: torch.Tensor) -> bool:
        self._tick()
        return bool(t)

    def ints(self, *ts: torch.Tensor) -> List[int]:
        """One transfer for several integer scalars."""
        self._tick()
        return torch.stack([t.reshape(()).long() for t in ts]).tolist()

    def numpy(self, t: torch.Tensor):
        """One transfer of a whole tensor to the host (numpy)."""
        self._tick()
        return t.cpu().numpy()


SYNCS = SyncCounter()
