"""Multi-tenant graph serving: many per-tenant graphs behind one
lane-batched engine and one admission queue (a port of
``repro.tenancy``).

* :mod:`repro_torch.tenancy.engine` -- :class:`TenantEngine`: per-tenant
  ``GraphState`` lanes stacked per capacity class, the 5-phase scan step
  run over the tenant axis (``dynamic.apply_batch_scan_lanes``), per-lane
  overflow isolation with solo grow-and-replay, and the ``(tenant_batch,
  scan_len, bucket)``-keyed dispatch registry with an asserted bound.
* :mod:`repro_torch.tenancy.queue` -- :class:`WorkQueue` (bounded
  admission, deadline/size-triggered cross-tenant coalescing,
  reject-with-retry-after backpressure) and :class:`TransferBufferPool`
  (pooled host buffers: steady-state submits allocate nothing).
* :mod:`repro_torch.tenancy.multi_service` -- :class:`MultiTenantService`:
  per-tenant :class:`repro_torch.api.GraphClient` sessions over the
  unchanged typed API, per-tenant generation counters / stats /
  durability (WAL + snapshots per tenant), and idle-tenant eviction with
  bit-identical WAL rehydration.
"""
from repro_torch.tenancy.engine import TenantEngine
from repro_torch.tenancy.multi_service import MultiTenantService
from repro_torch.tenancy.queue import QueueFull, TransferBufferPool, WorkQueue

__all__ = ["TenantEngine", "MultiTenantService", "WorkQueue",
           "TransferBufferPool", "QueueFull"]
