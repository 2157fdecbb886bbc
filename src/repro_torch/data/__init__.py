"""Data of the port: synthetic datasets, the update workload, the GNN
neighbour sampler and the LM token stream (copies of ``repro.data``'s
generators)."""
