"""Architecture configs of the port (``repro.configs``): the registry, the
decoder-LM family, the GNN family, DLRM-RM2 and the index itself."""
