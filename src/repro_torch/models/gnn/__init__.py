"""The GNN family of the port: EGNN, GatedGCN, NequIP and MACE, as
``repro.models.gnn``."""
