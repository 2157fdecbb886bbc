"""The GNN family (``repro.models.gnn``): GraphSAGE, GAT, GatedGCN and
DimeNet over padded edge lists."""
