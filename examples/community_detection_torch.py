"""The paper's §5.3 application on the PyTorch/CUDA port: on-line
community detection, as examples/community_detection.py runs it on the
JAX package.

A social-graph stream (80% membership checks / 20% friendship updates,
paper Fig 5c) runs against the typed client API: updates and community
queries (`SameSCC`, `CommunityOf`, `CommunitySizes`) all go through one
:class:`repro_torch.api.GraphClient` session, so every membership answer
carries the generation stamp of the committed snapshot it read.

    PYTHONPATH=src python examples/community_detection_torch.py   # card
    PYTHONPATH=src python examples/community_detection_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.api import (AddEdge, CommunityOf, CommunitySizes,
                             GraphClient, SameSCC)
from repro_torch.core import graph_state as gs
from repro_torch.core.service import SCCService
from repro_torch.launch.stream import typed_op_stream

NV = 1024

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=gs.DEFAULT_DEVICE)
ap.add_argument("--steps", type=int, default=5)
args = ap.parse_args()

cfg = gs.GraphConfig(n_vertices=NV, edge_capacity=2 ** 13, max_probes=128,
                     max_outer=64, max_inner=128)

# bootstrap a random social graph through the client (every user starts as
# a singleton community; friendships stream in as typed ops)
rng = np.random.default_rng(0)
svc = SCCService(cfg, buckets=(256, 1024),
                 state=gs.all_singletons(cfg, args.device))
client = GraphClient(svc)
client.submit_many([AddEdge(int(a), int(b)) for a, b in
                    zip(rng.integers(0, NV, 3000),
                        rng.integers(0, NV, 3000))])
st = client.stats()
print(f"bootstrap: {st['n_ccs']} communities over {NV} users "
      f"(gen {st['gen']}) on {st['device']}")

for step in range(args.steps):
    # 20% updates (friend/unfriend) -- one typed chunk through the client
    ops = typed_op_stream(NV, 64, step=step, add_frac=0.7,
                          include_vertex_ops=False)
    accepted = sum(r.value for r in client.submit_many(ops))
    # 80% queries -- coalesced by the broker against one committed snapshot
    qu = rng.integers(0, NV, 256)
    qv = rng.integers(0, NV, 256)
    res = client.submit_many(
        [SameSCC(int(a), int(b)) for a, b in zip(qu, qv)]
        + [CommunitySizes()])
    same, sizes = res[:-1], res[-1]
    rep = int(np.argmax(sizes.value))
    print(f"step {step}: applied {accepted}/64 updates, "
          f"{sum(r.value for r in same)}/256 pairs share a community, "
          f"largest community = {int(sizes.value[rep])} users (rep {rep}), "
          f"total = {client.stats()['n_ccs']} @gen {sizes.gen}")

# friend suggestions: same-community cohort matrix from CommunityOf labels
cohort = [int(x) for x in rng.integers(0, NV, 8)]
labels = client.submit_many([CommunityOf(u) for u in cohort])
lab = np.asarray([r.value for r in labels])
ok = lab < NV
pairs = (lab[:, None] == lab[None, :]) & ok[:, None] & ok[None, :]
print("suggestion matrix for cohort", cohort)
print(pairs.astype(int))
client.close()
