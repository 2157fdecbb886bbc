"""Core of the port: params, graph state, engine, update paths, session,
the two-tier index. Exports the names of ``repro.core`` that the port has;
the consolidation functions live in ``repro_torch.core.consolidate`` and
are not re-exported, as in JAX (a package-level ``consolidate`` would
shadow the submodule)."""
from repro_torch.core.graph import NULL, GraphState, graph_stats, init_graph
from repro_torch.core.maintenance import IPGMIndex, run_workload
from repro_torch.core.ops import OpBatch, apply_ops
from repro_torch.core.params import IndexParams, MaintenanceParams, SearchParams
from repro_torch.core.session import OpHandle, PhaseTimers, Session, params_fingerprint
from repro_torch.core.merge import StreamingMerge
from repro_torch.core.tiered import TieredOpHandle, TieredSession

__all__ = ["NULL", "GraphState", "graph_stats", "init_graph", "IPGMIndex",
           "run_workload", "IndexParams", "MaintenanceParams", "SearchParams",
           "OpBatch", "OpHandle", "PhaseTimers", "Session", "StreamingMerge",
           "TieredOpHandle", "TieredSession", "apply_ops",
           "params_fingerprint"]
