"""Spans and counters inside the program, for whoever traces it.

``span(name)`` opens a stretch of the program's work, entered and left by
the function that does it:

  ``search.entry_draw``   ``core/search.py::batch_entry_points``
  ``search.beam``         ``core/search.py::beam_search``
  ``graph.select``        ``core/select.py::select_neighbors``
  ``graph.apply``         ``core/graph.py::set_out_edges_batch``
  ``sharded.flat_view``, ``sharded.merge``
                          ``distributed/ann.py::flat_view``, ``_merge``
  ``collective.all_gather``, ``collective.all_reduce``
                          ``launch/mesh.py::CardGroup``, around the
                          collective, inside its synchronisations

With no sink installed (the default) a span costs one global read and
returns a shared null context: it launches, synchronises and allocates
nothing. ``set_sink(fn)`` installs ``fn``, which is then called with the
span's name on entry and again on exit (spans are well nested, so a sink
tells the two apart by the innermost open name), and arms the gathers'
valid-lane counter (``kernels/ops.py``); ``set_sink(None)`` removes both.
``tools/torch_session_profile.py`` installs a sink that times each span
on the host with the card synchronised at both ends.

``counters()`` is one snapshot of the program's counters: the beam
engine's ``loop_counts``, the kernels' ``launches`` and
``launches_by_shape``, and the gathers' valid lanes. Reading the valid
lanes synchronises with the card, so take it outside the work it measures,
before and after, and difference the two.
"""
from __future__ import annotations

import contextlib
import functools

_sink = None
_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("sink", "name")

    def __init__(self, sink, name: str):
        self.sink, self.name = sink, name

    def __enter__(self):
        self.sink(self.name)

    def __exit__(self, *exc):
        self.sink(self.name)
        return False


def span(name: str):
    """A context manager around the work of span ``name``."""
    sink = _sink
    return _NULL if sink is None else _Span(sink, name)


def spanned(name: str):
    """Decorate a function so that each call runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def set_sink(fn) -> None:
    """Install ``fn(name)`` as the sink of every span (None removes it)."""
    global _sink
    from repro_torch.kernels import ops

    _sink = fn
    ops.arm_valid_lanes(fn is not None)


def counters() -> dict:
    """``loop_counts``, ``launches``, ``launches_by_shape`` and
    ``valid_lanes`` (per gather), as they stand; one sync per card that
    holds a valid-lane buffer."""
    from repro_torch.core import search
    from repro_torch.kernels import ops

    return {"loop_counts": dict(search.loop_counts),
            "launches": dict(ops.launches),
            "launches_by_shape": {k: dict(v) for k, v in ops.launches_by_shape.items()},
            "valid_lanes": ops.read_valid_lanes()}
