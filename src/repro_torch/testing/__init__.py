"""Test support that ships with the library — ``repro.testing``.

``repro_torch.testing.faults`` marks the crash points of the session,
checkpoint manager, merge and two-tier index; with no fault plan active a
mark is one set lookup.
"""
from repro_torch.testing import faults

__all__ = ["faults"]
