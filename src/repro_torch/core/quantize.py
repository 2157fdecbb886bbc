"""Per-slot int8 vector codes — the compressed-scoring storage scheme.

Byte-equal to ``repro.core.quantize``: per-row symmetric max-abs scaling
``scale = max|x| · f32(1/127)`` (the reciprocal multiply, not a division),
``code = round(x / scale)`` with round-half-to-even (``torch.round``, like
``jnp.round``), clipped to ±127. A present all-zero row gets the positive
sentinel ``ZERO_ROW_SCALE`` so it never collides with the freed-slot
(zero codes, 0.0) scrub of invariant I5.

The asymmetric scores over these codes are computed by
``kernels.ops.gather_scores_q8``.
"""
from __future__ import annotations

import numpy as np
import torch

VECTOR_CODE_SCHEME = "int8-rowmax-rne-v2"
ZERO_ROW_SCALE = float(np.float32(2.0 ** -126))
_INV127 = float(np.float32(1.0 / 127.0))


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(codes i8[..., d], scales f32[...])`` over the last axis."""
    x32 = x.float()
    maxabs = torch.amax(torch.abs(x32), dim=-1)
    scales = maxabs * _INV127
    pos = maxabs > 0
    scales = torch.where(pos, scales, torch.full_like(scales, ZERO_ROW_SCALE))
    safe = torch.where(pos, scales, torch.ones_like(scales))
    codes = torch.clamp(torch.round(x32 / safe[..., None]), -127, 127)
    return codes.to(torch.int8), scales

