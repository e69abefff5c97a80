"""mace [arXiv:2206.07697]: n_layers=2 d_hidden=128 l_max=2
correlation_order=3 n_rbf=8, E(3)-equivariant (higher-order ACE message
passing, Cartesian-irrep realization); as ``repro.configs.mace``."""
from repro_torch.configs.gnn_shapes import gnn_shapes
from repro_torch.models.gnn import mace as model

FAMILY = "gnn"
SHAPES = gnn_shapes()
MODULE = model


def config(**kw):
    return model.MACEConfig(n_layers=2, d_hidden=128, l_max=2,
                            correlation=3, n_rbf=8, **kw)


def smoke_config(**kw):
    base = dict(n_layers=2, d_hidden=8, l_max=2, correlation=3, n_rbf=4,
                d_feat=6, n_graphs=2)
    base.update(kw)
    return model.MACEConfig(**base)
