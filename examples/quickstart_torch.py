"""Quickstart on the PyTorch/CUDA port: the SMSCC dynamic-SCC engine in 40
lines, as examples/quickstart.py runs it on the JAX package.

Builds a graph, applies a mixed update batch atomically, queries
communities -- the public API surface of the paper's contribution.

    PYTHONPATH=src python examples/quickstart_torch.py                # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import torch

from repro_torch.core import community, dynamic, graph_state as gs

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=gs.DEFAULT_DEVICE)
dev = torch.device(ap.parse_args().device)

# 1. capacity-bounded engine (vertices 0..63, up to 256 edges)
cfg = gs.GraphConfig(n_vertices=64, edge_capacity=256, max_probes=64,
                     max_outer=65, max_inner=66)
state = gs.empty(cfg, dev)

# 2. create vertices 0..9 in ONE atomic batch
ops = dynamic.make_ops([dynamic.ADD_VERTEX] * 10, list(range(10)), [0] * 10)
state, ok = dynamic.apply_batch(state, ops, cfg)
print("added vertices:", ok.tolist())

# 3. wire two cycles plus a bridge: {0,1,2} and {3,4}, 2->3
edges = [(0, 1), (1, 2), (2, 0), (3, 4), (4, 3), (2, 3)]
ops = dynamic.make_ops([dynamic.ADD_EDGE] * len(edges),
                       [u for u, _ in edges], [v for _, v in edges])
state, ok = dynamic.apply_batch(state, ops, cfg)
users = torch.arange(5, dtype=torch.int32, device=dev)
print("communities:", community.belongs_to_community(
    state, users).tolist())                     # -> [0, 0, 0, 3, 3]

# 4. the paper's Fig-2 moment: a back edge merges everything
state, _ = dynamic.apply_batch(
    state, dynamic.make_ops([dynamic.ADD_EDGE], [4], [0]), cfg)
print("after AddEdge(4,0):", community.belongs_to_community(
    state, users).tolist())                     # -> [0, 0, 0, 0, 0]
one = torch.tensor([1], dtype=torch.int32, device=dev)
four = torch.tensor([4], dtype=torch.int32, device=dev)
print("checkSCC(1, 4):", bool(community.check_scc(state, one, four)[0]))

# 5. the Fig-3 moment: deleting the bridge splits it again
state, _ = dynamic.apply_batch(
    state, dynamic.make_ops([dynamic.REM_EDGE], [2], [3]), cfg)
print("after RemoveEdge(2,3):", community.belongs_to_community(
    state, users).tolist())                     # -> [0, 0, 0, 3, 3]
print("n_sccs:", int(state.n_ccs), "on", dev)
