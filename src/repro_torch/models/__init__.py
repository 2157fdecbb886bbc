"""The model zoo's serving path (``repro.models``): shared layers, the
decoder-LM family with its MoE FFN, and DLRM. Each model is an
``nn.Module`` over plain functions on tensors."""
