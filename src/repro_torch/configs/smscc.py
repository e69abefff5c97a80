"""The SMSCC engine's own configuration: a copy of ``repro.configs.smscc``
(same shapes, same defaults), building the port's GraphConfig."""
from repro_torch.core import graph_state as gs

FAMILY = "smscc"

# Scan-length registry: runs of same-bucket chunks are stacked into
# super-chunks of the largest registered length that fits, and each
# super-chunk's outputs are read back once.
SCAN_LENGTHS = (1, 4, 16)

SHAPES = {
    "update_1m": dict(kind="update", n_vertices=2 ** 20,
                      edge_capacity=2 ** 23, batch=8192),
    "update_16m": dict(kind="update", n_vertices=2 ** 24,
                       edge_capacity=2 ** 26, batch=65536),
    "community_query": dict(kind="query", n_vertices=2 ** 20,
                            edge_capacity=2 ** 23, batch=262144),
}


def config(n_vertices=2 ** 20, edge_capacity=2 ** 23, **kw):
    """Compact repair tier on (regions up to 1/8 of the vertex slots),
    dense tier off unless ``dense_capacity`` is given, repair gate on."""
    base = dict(max_probes=64, max_outer=64, max_inner=256,
                region_vertex_capacity=max(64, n_vertices // 8),
                region_edge_buckets=(256, 4096, 65536), repair_gate=True)
    base.update(kw)
    return gs.GraphConfig(n_vertices=n_vertices,
                          edge_capacity=edge_capacity, **base)


def smoke_config(**kw):
    base = dict(n_vertices=64, edge_capacity=256, max_probes=256,
                max_outer=65, max_inner=66)
    base.update(kw)
    return gs.GraphConfig(**base)
