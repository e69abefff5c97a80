"""High-availability primitives for the durable write path.

:mod:`repro_torch.ha.lease` is the leadership protocol: a file-based lease
whose monotonically bumped epoch IS the WAL fencing token
(:mod:`repro_torch.ckpt.oplog`).  :class:`repro_torch.ckpt.durable.
DurableService` holds the lease; :meth:`repro_torch.core.replicas.Replica.
promote` takes it over.
"""
from repro_torch.ha.lease import FileLease, LeaseInfo

__all__ = ["FileLease", "LeaseInfo"]
