"""The four GNN input shapes (shared across the 4 GNN archs), as
``repro.configs.gnn_shapes``.

minibatch_lg block shapes follow the sampler layout
(data/pipeline.sampled_block_batch): widest layer first, node table =
inputs ++ inner-frontiers ++ seeds.
"""

FULL_GRAPH_SM = dict(kind="train_full", n_nodes=2708, n_edges=10556,
                     d_feat=1433, n_classes=7)          # Cora
MINIBATCH_LG = dict(kind="train_sampled", n_nodes=232965,
                    n_edges=114615892, batch_nodes=1024,
                    fanouts=(15, 10), d_feat=602, n_classes=41)  # Reddit
OGB_PRODUCTS = dict(kind="train_full", n_nodes=2449029, n_edges=61859140,
                    d_feat=100, n_classes=47)
MOLECULE = dict(kind="train_mol", n_nodes=30, n_edges=64, batch=128,
                d_feat=16)


def gnn_shapes():
    return {
        "full_graph_sm": dict(FULL_GRAPH_SM),
        "minibatch_lg": dict(MINIBATCH_LG),
        "ogb_products": dict(OGB_PRODUCTS),
        "molecule": dict(MOLECULE),
    }


def sampled_block_dims(shape):
    """(n_local_nodes, n_local_edges) of a minibatch_lg block batch."""
    b = shape["batch_nodes"]
    f = list(shape["fanouts"])
    # frontier sizes: seeds=b, after f[0]: b*f[0], after f[1]: b*f[0]*f[1]
    fronts = [b]
    for x in f:
        fronts.append(fronts[-1] * x)
    n_nodes = sum(fronts)              # seeds + all frontiers
    n_edges = sum(fronts[1:])          # one edge per sampled neighbor
    return n_nodes, n_edges
