"""The bytes a kernel must move, counted from the cell's logical sizes, and
the card's peak: the yardstick of every ``<kernel>_roofline`` metric.

Each count is what the operation needs whatever implements it: every
input byte read once and every output byte written once.  Nothing here
depends on the program's layout: not the edge table's capacity, nor the
edge lists or buffers a kernel builds for itself.

- A fixpoint sweep or a static SCC over the live graph (frontier_min's
  ``fixpoint_rounds`` and ``scc_rounds`` launches): each live edge's
  (src, dst), 8 B, once; each vertex's state, one 4-byte word, once; each
  vertex's output word once.
- The packed Reachable sweeps (frontier_min's ``fixpoint_rounds`` in its
  OR form): each live edge once a sweep; each vertex's reached bit of each
  query answered, in and out once (4-byte words of 32 queries).
- An edge-table insert or remove (hash_probe's ``insert_rounds``,
  ``remove_first``): each op's key (u, v) in, 8 B, and its ack out, 1 B;
  for an insert the slot it fills, key and state, 9 B; for a remove the
  state byte it writes.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 80 GB data sheet: HBM3 bandwidth, at a 700 W limit
HBM_BYTES_PER_S = 3.35e12

EDGE_BYTES = 8  # a live edge's (src, dst) int32 pair
WORD_BYTES = 4  # a vertex's state or output word
ACK_BYTES = 1
INSERT_SLOT_BYTES = 9  # key and state of the slot an insert fills
REMOVE_SLOT_BYTES = 1  # the state byte a remove writes


def sweep_bytes(live_edges: int, n_vertices: int) -> int:
    """One fixpoint sweep or static SCC over the live graph."""
    return live_edges * EDGE_BYTES + 2 * n_vertices * WORD_BYTES


def packed_sweeps_bytes(launches: int, live_edges: int, n_vertices: int,
                        queries: int) -> float:
    """``launches`` packed Reachable sweeps that answer ``queries``
    queries between them: each reads the live graph once, and each
    query's reached bit of every vertex is read and written once."""
    return (launches * live_edges * EDGE_BYTES
            + 2 * n_vertices * WORD_BYTES * queries / 32)


def insert_bytes(ops: int) -> int:
    return ops * (EDGE_BYTES + ACK_BYTES + INSERT_SLOT_BYTES)


def remove_bytes(ops: int) -> int:
    return ops * (EDGE_BYTES + ACK_BYTES + REMOVE_SLOT_BYTES)


def share_pct(nbytes: float, device_s: float) -> float | None:
    """The bound's share of the measured device seconds, in percent; None
    when nothing ran."""
    if device_s <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / device_s
