"""Counted host synchronisations.

JAX keeps the fixpoint loops, the repair gate and the tier dispatch on the
device (``lax.while_loop`` / ``lax.cond``).  The port runs them as Python
control flow, so each decision reads one value back from the device.
Every such read goes through :data:`SYNCS`, so a run can report how many
host syncs a step costs.
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


SYNCS = SyncCounter()
