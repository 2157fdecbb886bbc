"""Step builders and the optimizer of the port (``repro.train``): the
serving steps, the GNN forward and train steps, AdamW."""
