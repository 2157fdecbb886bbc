"""GNN substrate (``repro.models.gnn.common``): static-shape graph batches,
segment message passing, and the parameter tree the GNN models share.

Message passing runs directly over an edge list: ``index_add_`` for the
sums, ``scatter_reduce("amax")`` for the segment max. All shapes are
static: graphs are padded to (n_nodes, n_edges[, n_triplets]) with
validity masks, and padded edges point at node 0 with mask False, so they
add exact zeros. Ids out of range read and write as in JAX, where torch
would raise: a gather reads a negative id from the end and clamps the rest
into ``[0, n)`` (its gradient drops what the clamp moved, as XLA's
scatter does), and a scatter drops every id outside ``[0, n)`` (it adds
into a spare row ``n`` that is cut off).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models.layers import jax_take

# the messages one chunk of ``neighbour_sum`` holds: products' layer 2
# would hold [61.9 M, 128] fp32 (31.7 GB), twice with its masked copy
EDGE_CHUNK_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class GraphData:
    """One (possibly merged/padded) graph batch."""

    x: torch.Tensor            # f32[N, F] node features
    senders: torch.Tensor      # i32[E]
    receivers: torch.Tensor    # i32[E]
    node_mask: torch.Tensor    # bool[N]
    edge_mask: torch.Tensor    # bool[E]
    labels: torch.Tensor       # i32[N] node labels (classification) or zeros
    label_mask: torch.Tensor   # bool[N] which nodes are supervised
    positions: torch.Tensor    # f32[N, 3] (geometric models; zeros otherwise)
    edge_attr: torch.Tensor    # f32[E, De] (gatedgcn; zeros otherwise)
    graph_ids: torch.Tensor    # i32[N] graph membership (batched small graphs)
    targets: torch.Tensor      # f32[G] graph-level regression targets

    @property
    def n_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def n_edges(self) -> int:
        return self.senders.shape[0]

    def to(self, device) -> GraphData:
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)})


def _as(a, dtype, device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(device=device, dtype=dtype)


def make_graph(
    x, senders, receivers, *, labels=None, label_mask=None, node_mask=None,
    edge_mask=None, positions=None, edge_attr=None, d_edge=8, graph_ids=None,
    targets=None, n_graphs=1, device=None,
) -> GraphData:
    """Arrays or tensors → a :class:`GraphData` on ``device`` (``cuda``
    unless the caller passes ``"cpu"``), with JAX's defaults for the
    fields not given."""
    dev = resolve_device(device)
    N, E = x.shape[0], senders.shape[0]

    def field(a, dtype, default_shape, fill):
        if a is None:
            return torch.full(default_shape, fill, dtype=dtype, device=dev)
        return _as(a, dtype, dev)

    return GraphData(
        x=_as(x, torch.float32, dev),
        senders=_as(senders, torch.int32, dev),
        receivers=_as(receivers, torch.int32, dev),
        node_mask=field(node_mask, torch.bool, (N,), True),
        edge_mask=field(edge_mask, torch.bool, (E,), True),
        labels=field(labels, torch.int32, (N,), 0),
        label_mask=field(label_mask, torch.bool, (N,), True),
        positions=field(positions, torch.float32, (N, 3), 0.0),
        edge_attr=field(edge_attr, torch.float32, (E, d_edge), 0.0),
        graph_ids=field(graph_ids, torch.int32, (N,), 0),
        targets=field(targets, torch.float32, (n_graphs,), 0.0),
    )


def scatter_ids(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``idx`` with every id outside ``[0, n)`` sent to the spare row
    ``n``: JAX's segment ops drop such ids."""
    return torch.where((idx >= 0) & (idx < n), idx, n)


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along the first axis, as JAX reads and differentiates it
    (``models.layers.jax_take``)."""
    return jax_take(x, idx)


def scatter_sum(messages: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """Σ over incoming edges — the message-passing primitive."""
    out = messages.new_zeros((n + 1,) + tuple(messages.shape[1:]))
    return out.index_add_(0, scatter_ids(dst, n), messages)[:n]


def segment_max(x: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """Per-segment max; ``-inf`` for a segment nothing is sent to."""
    out = x.new_full((n + 1,) + tuple(x.shape[1:]), float("-inf"))
    idx = scatter_ids(dst, n).long().view((-1,) + (1,) * (x.dim() - 1)).expand_as(x)
    return out.scatter_reduce(0, idx, x, "amax", include_self=False)[:n]


def segment_mean(messages, dst, mask, n) -> torch.Tensor:
    m = torch.where(mask[:, None], messages, 0.0)
    tot = scatter_sum(m, dst, n)
    cnt = scatter_sum(mask.float(), dst, n)
    return tot / torch.clamp(cnt, min=1.0)[:, None]


def segment_softmax(scores, dst, mask, n) -> torch.Tensor:
    """Edge softmax per receiving node (GAT): numerically stable.

    scores: [E] or [E, H]; mask: bool[E]. A segment with no unmasked edge
    has max ``-inf``, replaced by 0 before the subtraction, so its masked
    edges give ``exp(-inf) = 0`` and no NaN reaches the backward pass.
    """
    m = mask if scores.dim() == 1 else mask[:, None]
    s = torch.where(m, scores, float("-inf"))
    smax = segment_max(s, dst, n)
    smax = torch.where(torch.isfinite(smax), smax, 0.0)
    e = torch.where(m, torch.exp(s - gather(smax, dst)), 0.0)
    z = scatter_sum(e, dst, n)
    return e / torch.clamp(gather(z, dst), min=1e-16)


def degree(dst, mask, n) -> torch.Tensor:
    return scatter_sum(mask.float(), dst, n)


def neighbour_sum(h, src, dst, mask, n, *, chunk_bytes: int = EDGE_CHUNK_BYTES
                  ) -> torch.Tensor:
    """``scatter_sum(where(mask, h[src], 0), dst, n)`` over edge chunks of
    at most ``chunk_bytes`` of messages, so ``[E, d]`` is never held whole.
    The chunks add in edge order, so on the CPU the sums are those of one
    ``index_add_`` over every edge."""
    out = h.new_zeros((n + 1,) + tuple(h.shape[1:]))
    row_bytes = max(1, h[0].numel() * h.element_size())
    step = max(1, chunk_bytes // row_bytes)
    for lo in range(0, src.shape[0], step):
        msgs = gather(h, src[lo:lo + step])
        msgs.masked_fill_(~mask[lo:lo + step, None], 0.0)
        out.index_add_(0, scatter_ids(dst[lo:lo + step], n), msgs)
    return out[:n]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class ParamTree(nn.Module):
    """A JAX parameter tree as a module.

    A dict becomes a module whose entries are registered in sorted key
    order, a list or tuple one whose entries are named ``"0"``, ``"1"``,
    ...; a dense layer's ``{"w": a}`` becomes its weight ``a``, as in
    ``models/layers.py``. So ``leaves()`` yields the parameters in
    ``jax.tree.leaves``' order (``parameters()`` would list a module's own
    tensors before its children's), and the forward code reads like JAX's:
    ``params.layers[0].w_self``; a tuple unpacks as JAX's pair does.
    """

    def __init__(self, tree, device=None):
        super().__init__()
        self._seq = isinstance(tree, (list, tuple))
        self._order = []
        for k, v in (enumerate(tree) if self._seq else sorted(tree.items())):
            name = str(k)
            if isinstance(v, dict) and set(v) == {"w"}:
                v = v["w"]
            if isinstance(v, (dict, list, tuple)):
                self.add_module(name, ParamTree(v, device))
            else:
                t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
                self.register_parameter(name, nn.Parameter(t.to(device)))
            self._order.append(name)

    def leaves(self):
        for name in self._order:
            if name in self._parameters:
                yield self._parameters[name]
            else:
                yield from self._modules[name].leaves()

    def __getitem__(self, key):
        return getattr(self, str(key))

    def __iter__(self):
        if not self._seq:
            raise TypeError("iterate over a list or tuple node of the tree")
        return (self[name] for name in self._order)

    def __len__(self) -> int:
        return len(self._order)
