"""Neighbor sampler — the real minibatch_lg data path (GraphSAGE-style);
a copy of ``repro.data.graph_sampler``, numpy only, whose batches are
byte-equal to the original's for a seed.

Host-side CSR uniform fanout sampling producing fixed-size padded blocks
(deepest-hop-first) matching configs/gnn_common layouts. Resumable: the
sampler carries an epoch/cursor state for preemption restarts.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray   # i64[N+1]
    indices: np.ndarray  # i32[E]
    feats: np.ndarray    # f32[N, F]
    labels: np.ndarray   # i64[N]

    @property
    def n_nodes(self) -> int:
        return self.indptr.shape[0] - 1


def build_csr(n_nodes: int, senders: np.ndarray, receivers: np.ndarray,
              feats: np.ndarray, labels: np.ndarray) -> CSRGraph:
    order = np.argsort(senders, kind="stable")
    s, r = senders[order], receivers[order]
    counts = np.bincount(s, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRGraph(indptr, r.astype(np.int32), feats, labels)


def random_graph(n_nodes: int, avg_degree: int, d_feat: int, n_classes: int,
                 *, seed: int = 0) -> CSRGraph:
    rng = np.random.default_rng(seed)
    E = n_nodes * avg_degree
    senders = rng.integers(0, n_nodes, E)
    receivers = rng.integers(0, n_nodes, E)
    feats = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, n_nodes)
    return build_csr(n_nodes, senders, receivers, feats, labels)


@dataclasses.dataclass
class SamplerState:
    epoch: int = 0
    cursor: int = 0

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    def load_state_dict(self, d: dict) -> None:
        self.epoch, self.cursor = int(d["epoch"]), int(d["cursor"])


class NeighborSampler:
    """Uniform fanout sampler with -1 padding for low-degree nodes."""

    def __init__(self, g: CSRGraph, fanout: tuple[int, ...], batch: int,
                 *, seed: int = 0):
        self.g = g
        self.fanout = fanout
        self.batch = batch
        self.rng = np.random.default_rng(seed)
        self.state = SamplerState()
        self._perm = self.rng.permutation(g.n_nodes)

    def _sample_neighbors(self, nodes: np.ndarray, fan: int) -> np.ndarray:
        """[len(nodes)·fan] sampled neighbor ids (-1 padded)."""
        out = np.full((nodes.shape[0], fan), -1, np.int64)
        for i, n in enumerate(nodes):
            if n < 0:
                continue
            lo, hi = self.g.indptr[n], self.g.indptr[n + 1]
            deg = hi - lo
            if deg == 0:
                continue
            take = self.rng.integers(lo, hi, size=fan) if deg > fan else \
                np.concatenate([np.arange(lo, hi),
                                self.rng.integers(lo, hi, size=fan - deg)])
            out[i] = self.g.indices[take[:fan]]
        return out.reshape(-1)

    def next_batch(self) -> dict:
        """Blocks dict matching configs/gnn_common minibatch layout."""
        N = self.g.n_nodes
        if self.state.cursor + self.batch > N:
            self.state.epoch += 1
            self.state.cursor = 0
            self._perm = self.rng.permutation(N)
        targets = self._perm[self.state.cursor:self.state.cursor + self.batch]
        self.state.cursor += self.batch

        layers = [targets]
        for fan in self.fanout:
            layers.append(self._sample_neighbors(layers[-1], fan))
        # deepest-first feature blocks + masks
        feats, masks = [], []
        for nodes in reversed(layers):
            m = nodes >= 0
            f = np.zeros((nodes.shape[0], self.g.feats.shape[1]), np.float32)
            f[m] = self.g.feats[nodes[m]]
            feats.append(f)
            masks.append(m)
        return {
            "blocks": {"feats": feats, "masks": masks},
            "block_labels": self.g.labels[targets].astype(np.int32),
            "block_label_mask": np.ones(self.batch, bool),
        }

    def as_subgraph(self) -> dict:
        """One sampled batch as a merged edge-list subgraph (for non-SAGE
        archs on the minibatch_lg cell)."""
        N = self.g.n_nodes
        if self.state.cursor + self.batch > N:
            self.state.epoch += 1
            self.state.cursor = 0
            self._perm = self.rng.permutation(N)
        targets = self._perm[self.state.cursor:self.state.cursor + self.batch]
        self.state.cursor += self.batch

        layers = [targets]
        senders, receivers = [], []
        offset = 0
        next_offset = self.batch
        for fan in self.fanout:
            nbrs = self._sample_neighbors(layers[-1], fan)
            src_pos = np.arange(nbrs.shape[0]) + next_offset
            dst_pos = np.repeat(np.arange(layers[-1].shape[0]) + offset, fan)
            valid = nbrs >= 0
            senders.append(src_pos[valid])
            receivers.append(dst_pos[valid])
            offset = next_offset
            next_offset += nbrs.shape[0]
            layers.append(nbrs)
        all_nodes = np.concatenate(layers)
        node_mask = all_nodes >= 0
        feats = np.zeros((all_nodes.shape[0], self.g.feats.shape[1]), np.float32)
        feats[node_mask] = self.g.feats[all_nodes[node_mask]]
        labels = np.zeros(all_nodes.shape[0], np.int32)
        labels[: self.batch] = self.g.labels[targets]
        label_mask = np.zeros(all_nodes.shape[0], bool)
        label_mask[: self.batch] = True
        return {
            "x": feats,
            "senders": np.concatenate(senders).astype(np.int32),
            "receivers": np.concatenate(receivers).astype(np.int32),
            "node_mask": node_mask,
            "labels": labels,
            "label_mask": label_mask,
        }
