"""Core of the port: params, graph state, engine, update paths, session,
the two-tier index."""
from repro_torch.core.params import IndexParams, MaintenanceParams, SearchParams
from repro_torch.core.session import OpHandle, PhaseTimers, Session, params_fingerprint
from repro_torch.core.merge import StreamingMerge
from repro_torch.core.tiered import TieredOpHandle, TieredSession

__all__ = ["IndexParams", "MaintenanceParams", "SearchParams", "OpHandle",
           "PhaseTimers", "Session", "StreamingMerge", "TieredOpHandle",
           "TieredSession", "params_fingerprint"]
