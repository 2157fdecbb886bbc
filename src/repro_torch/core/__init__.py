"""Core of the port: params, graph state, engine, update paths, session."""
from repro_torch.core.params import IndexParams, MaintenanceParams, SearchParams
from repro_torch.core.session import OpHandle, PhaseTimers, Session, params_fingerprint

__all__ = ["IndexParams", "MaintenanceParams", "SearchParams", "OpHandle",
           "PhaseTimers", "Session", "params_fingerprint"]
