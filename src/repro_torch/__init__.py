"""PyTorch/CUDA port of the online proximity-graph index (``repro``).

The port mirrors ``repro``'s layout (``core``, ``kernels``, ``data``) and
imports neither ``jax`` nor any ``repro`` module. Entry points run on the
CUDA device unless the caller passes ``device="cpu"``; the kernels' plain
PyTorch versions serve CPU tensors.
"""
import torch

# fp32 everywhere: the exact-id top-k and the parity tests need full fp32
# products, never TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``. A CUDA request without a card raises: the port
    never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the port's "
            "plain PyTorch path")
    return dev
