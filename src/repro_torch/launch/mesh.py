"""Device meshes (``repro.launch.mesh``): axis sizes, and groups of cards.

JAX builds its meshes over real or forced host devices. A mesh here is a
:class:`ShardMesh`: axis names and sizes, with no devices and no process
group. The sharding rules, the collective model and the planner read
nothing else of a mesh. Besides JAX's production meshes there are the two
layouts of the H100: one card, and four cards as FSDP × TP (``data`` 2 ×
``model`` 2).

The devices behind a mesh are a :class:`CardGroup`: one process ("rank")
per card, joined by ``torch.distributed`` (NCCL on cards, rank r on
``cuda:r``; gloo on the CPU, only where the caller passes ``device="cpu"``).
:func:`run_on_ranks` starts one process per rank and collects what each
returns; it is the port's counterpart of ``jax.make_mesh`` over real
devices for the sharded index (``distributed/ann.py``). A mesh with a
``pod`` axis puts each pod on its own ranks: :meth:`CardGroup.split` gives
a rank the subgroup of its pod (the replica group) and the subgroup of the
ranks at its place in every pod (the pod-peer group).
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Iterator

import torch

from repro_torch import tracing


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """The axis sizes of a device mesh, with no devices: the port's stand-in
    for ``jax.make_mesh(shape, axis_names)``."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError("one size per axis name")
        if any(int(n) < 1 for n in self.shape):
            raise ValueError(f"axis sizes must be positive: {self.shape}")

    def size(self, axis: str) -> int:
        return int(self.shape[self.axis_names.index(axis)])

    @property
    def axis_sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, (int(n) for n in self.shape)))

    @property
    def n_devices(self) -> int:
        return math.prod(int(n) for n in self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> ShardMesh:
    """16×16 = 256 chips per pod; 2 pods = 512 chips for the multi-pod pass."""
    if multi_pod:
        return ShardMesh((2, 16, 16), ("pod", "data", "model"))
    return ShardMesh((16, 16), ("data", "model"))


def make_debug_mesh(n_data: int = 4, n_model: int = 2, *,
                    multi_pod: bool = False) -> ShardMesh:
    if multi_pod:
        return ShardMesh((2, n_data, n_model), ("pod", "data", "model"))
    return ShardMesh((n_data, n_model), ("data", "model"))


def one_card() -> ShardMesh:
    return ShardMesh((1, 1), ("data", "model"))


def four_cards() -> ShardMesh:
    """Four H100s of one host as FSDP over ``data`` × TP over ``model``."""
    return ShardMesh((2, 2), ("data", "model"))


LAYOUTS = {"one": one_card, "four": four_cards}


def batch_axes(mesh: ShardMesh) -> tuple[str, ...]:
    """Axes the batch/token dim shards over (pod extends data when present)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def all_axes(mesh: ShardMesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)


# ---------------------------------------------------------------------------
# groups of cards
# ---------------------------------------------------------------------------

# a bool or bf16 tensor crosses a collective as its bytes (uint8), a type
# every backend carries
_WIRE_DTYPES = (torch.bool, torch.bfloat16)


@dataclasses.dataclass
class CardGroup:
    """This process's place in a group of ranks, one per card: ``rank`` of
    ``world``, its ``device`` (``cuda:rank``, or the CPU under gloo) and the
    ``torch.distributed`` process group. The collectives synchronise the
    card before and after, so ``collective_s`` is the host time from the
    rank's inputs being ready to its results being ready, waiting for the
    slowest rank included."""

    rank: int
    world: int
    device: torch.device
    pg: Any
    collective_s: float = 0.0
    n_collectives: int = 0
    timeout_s: float = 1800.0
    _splits: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def open(cls, rank: int, world: int, store_path: str, *, device,
             timeout_s: float) -> "CardGroup":
        """Join the group over a ``FileStore`` at ``store_path``: NCCL when
        ``device`` is a card (the rank's card becomes the current device),
        gloo on the CPU. Runs one collective, so a group that cannot come
        up raises here."""
        import torch.distributed as dist

        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device available for a NCCL group")
            if torch.cuda.device_count() < world:
                raise RuntimeError(f"{world} ranks need {world} cards, "
                                   f"{torch.cuda.device_count()} found")
            torch.cuda.set_device(rank)
            dev = torch.device("cuda", rank)
            backend = "nccl"
        elif dev.type == "cpu":
            backend = "gloo"
        else:
            raise ValueError(f"no process group for device {dev}")
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        group = cls(rank, world, dev, dist.group.WORLD, timeout_s=timeout_s)
        group._probe()
        return group

    def _probe(self) -> None:
        """One collective over the group, so a group that cannot come up
        raises here (and NCCL's lazy set-up is not billed to the first
        op); the counters start after it."""
        probe = self.all_reduce(torch.ones(1, dtype=torch.int32,
                                           device=self.device), "sum")
        if int(probe) != self.world:
            raise RuntimeError(f"group came up with {int(probe)} of "
                               f"{self.world} ranks")
        self.collective_s, self.n_collectives = 0.0, 0

    def split(self, pods: int) -> tuple["CardGroup", "CardGroup"]:
        """(replica group, pod-peer group) of this rank when ``pods`` pods
        of G = world / pods ranks each lie row-major over the ranks: the
        ranks ``[p·G, (p+1)·G)`` of its pod p, and the ranks ``g, G + g,
        …`` at its place g in every pod, each in rank order. Every rank
        creates every subgroup, in the same order (``new_group`` is
        collective over the whole group), and each runs one probe
        collective. Made once per ``pods``."""
        import torch.distributed as dist

        if pods not in self._splits:
            if pods < 1 or self.world % pods:
                raise ValueError(f"{self.world} ranks do not split over "
                                 f"{pods} pods")
            G = self.world // pods
            layouts = ([list(range(p * G, (p + 1) * G)) for p in range(pods)]
                       + [list(range(g, self.world, G)) for g in range(G)])
            mine = []
            for ranks in layouts:
                pg = dist.new_group(ranks, timeout=datetime.timedelta(
                    seconds=self.timeout_s))
                if self.rank in ranks:
                    mine.append(CardGroup(ranks.index(self.rank), len(ranks),
                                          self.device, pg,
                                          timeout_s=self.timeout_s))
            for sub in mine:
                sub._probe()
            self._splits[pods] = tuple(mine)
        return self._splits[pods]

    def close(self) -> None:
        """Leave the group (the whole group's close also ends its
        subgroups)."""
        import torch.distributed as dist

        dist.destroy_process_group(self.pg)

    def _timed(self, name: str, fn):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        with tracing.span(name):
            out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.collective_s += time.perf_counter() - t0
        self.n_collectives += 1
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated on dim 0 in rank order."""
        import torch.distributed as dist

        wire = t.dtype in _WIRE_DTYPES
        x = t.contiguous()
        x = x.view(torch.uint8) if wire else x
        parts = [torch.empty_like(x) for _ in range(self.world)]
        self._timed("collective.all_gather", lambda: dist.all_gather(parts, x, group=self.pg))
        out = torch.cat(parts) if x.dim() else torch.stack(parts)
        return out.view(t.dtype) if wire else out

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """``t`` reduced over the ranks (``op`` "sum" or "max"), in place;
        integer tensors only where the result must not depend on the
        order of the reduction."""
        import torch.distributed as dist

        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        self._timed("collective.all_reduce", lambda: dist.all_reduce(t, op=red, group=self.pg))
        return t


@contextlib.contextmanager
def one_rank(device, *, timeout_s: float) -> Iterator[CardGroup]:
    """A group of one rank in this process (NCCL on a card, gloo on the
    CPU): the sharded path with its collectives, on one device."""
    with tempfile.TemporaryDirectory(prefix="rank-") as tmp:
        group = CardGroup.open(0, 1, os.path.join(tmp, "store"),
                               device=device, timeout_s=timeout_s)
        try:
            yield group
        finally:
            group.close()


def _rank_main(fn, rank: int, world: int, store_path: str, device,
               timeout_s: float, args: tuple, results) -> None:
    """A spawned rank: join the group, run ``fn(group, *args)``, report
    ``(rank, ok, value or traceback)``; a failure is re-raised after its
    report, so the process exits with code 1."""
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        group = CardGroup.open(rank, world, store_path, device=device,
                               timeout_s=timeout_s)
        value = fn(group, *args)
        group.close()
        results.put((rank, True, value))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        results.close()
        results.join_thread()


class RankFailure(RuntimeError):
    """A rank of :func:`run_on_ranks` raised, died or missed the deadline."""


def run_on_ranks(fn: Callable, world: int, *, device, timeout_s: float,
                 args: tuple = ()) -> list:
    """Run ``fn(group, *args)`` on ``world`` ranks, each a process started
    with ``spawn`` (CUDA cannot follow a ``fork``), and return their values
    in rank order. ``fn`` and ``args`` must pickle: ``fn`` lives in an
    importable module or in the ``__main__`` script. The first rank that
    raises or dies, or a deadline of ``timeout_s`` seconds, stops every rank
    and raises :class:`RankFailure` here with that rank's traceback."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, os.path.join(tmp, "store"),
                                   device, timeout_s, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        values: dict[int, Any] = {}
        failure = None
        try:
            while len(values) < world and failure is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    failure = (f"ranks {sorted(set(range(world)) - set(values))}"
                               f" missed the {timeout_s:.0f} s deadline")
                    break
                try:
                    rank, ok, value = results.get(timeout=min(left, 0.5))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in values and not p.is_alive()
                            and p.exitcode != 0]
                    if dead and results.empty():
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode}")
                    continue
                if ok:
                    values[rank] = value
                else:
                    failure = f"rank {rank} raised:\n{value}"
        finally:
            for p in procs:
                p.join(timeout=max(0.0, min(10.0, deadline - time.monotonic()))
                       if failure is None else 0.0)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
        if failure is None:
            bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
            if bad:
                failure = (f"rank {bad[0]} exited with code "
                           f"{procs[bad[0]].exitcode}")
        if failure is not None:
            raise RankFailure(failure)
        return [values[r] for r in range(world)]
