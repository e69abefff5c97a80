"""egnn [arXiv:2102.09844]: n_layers=4 d_hidden=64, E(n)-equivariant; as
``repro.configs.egnn``."""
from repro_torch.configs.gnn_shapes import gnn_shapes
from repro_torch.models.gnn import egnn as model

FAMILY = "gnn"
SHAPES = gnn_shapes()
MODULE = model


def config(**kw):
    return model.EGNNConfig(n_layers=4, d_hidden=64, **kw)


def smoke_config(**kw):
    base = dict(n_layers=2, d_hidden=16, d_feat=6, n_graphs=2)
    base.update(kw)
    return model.EGNNConfig(**base)
