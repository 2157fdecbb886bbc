"""Helpers for the tests that hold ``repro_torch`` against ``repro``.

Both packages get the same numpy inputs; a JAX ``GraphState`` crosses over
as ``np.asarray`` of each field. Everything here runs on the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

import repro_torch.core.params as tparams
from repro_torch.core.graph import DATA_FIELDS, graph_state_from_numpy

# the tier-1 run shares the machine's cores between several pytest workers
# and XLA's own thread pool; a few intra-op threads are enough at these sizes
torch.set_num_threads(2)

INT_FIELDS = ("adj", "radj", "alive", "present", "size", "stamps", "clock",
              "touch", "tclock", "codes", "scales")


def torch_params(p):
    """A ``repro`` params dataclass → its ``repro_torch`` twin."""
    cls = getattr(tparams, type(p).__name__)
    kw = {}
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        kw[f.name] = torch_params(v) if dataclasses.is_dataclass(v) else v
    return cls(**kw)


def torch_state(js, device="cpu"):
    """A ``repro`` GraphState → a fresh ``repro_torch`` GraphState."""
    return graph_state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in DATA_FIELDS},
        capacity=js.capacity, dim=js.dim, d_out=js.d_out, d_in=js.d_in,
        metric=js.metric, device=device)


def state_diff(js, ts, fields=DATA_FIELDS) -> list[str]:
    """Fields whose bytes differ between a JAX and a torch state."""
    return [f for f in fields
            if not np.array_equal(np.asarray(getattr(js, f)),
                                  getattr(ts, f).cpu().numpy())]


def int_vectors(rng, n, d):
    """Integer-valued vectors: every fp32 dot product is exact in any
    summation order, so results must be byte-equal and ties abound."""
    return rng.integers(-4, 5, (n, d)).astype(np.float32)
