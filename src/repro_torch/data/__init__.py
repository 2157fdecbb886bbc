"""Data of the port: synthetic datasets, the update workload and the GNN
neighbour sampler (copies of ``repro.data``'s generators)."""
