"""gatedgcn [arXiv:2003.00982 benchmark config]: n_layers=16 d_hidden=70,
gated edge aggregation; as ``repro.configs.gatedgcn``."""
from repro_torch.configs.gnn_shapes import gnn_shapes
from repro_torch.models.gnn import gatedgcn as model

FAMILY = "gnn"
SHAPES = gnn_shapes()
MODULE = model


def config(**kw):
    return model.GatedGCNConfig(n_layers=16, d_hidden=70, **kw)


def smoke_config(**kw):
    base = dict(n_layers=3, d_hidden=16, d_feat=6, n_graphs=2)
    base.update(kw)
    return model.GatedGCNConfig(**base)
