"""nequip [arXiv:2101.03164]: n_layers=5 d_hidden=32 l_max=2 n_rbf=8
cutoff=5, O(3)-equivariant tensor-product interatomic potential; as
``repro.configs.nequip``."""
from repro_torch.configs.gnn_shapes import gnn_shapes
from repro_torch.models.gnn import nequip as model

FAMILY = "gnn"
SHAPES = gnn_shapes()
MODULE = model


def config(**kw):
    return model.NequIPConfig(n_layers=5, d_hidden=32, l_max=2, n_rbf=8,
                              cutoff=5.0, **kw)


def smoke_config(**kw):
    base = dict(n_layers=2, d_hidden=8, l_max=2, n_rbf=4, d_feat=6,
                n_graphs=2)
    base.update(kw)
    return model.NequIPConfig(**base)
