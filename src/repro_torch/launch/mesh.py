"""Device meshes (``repro.launch.mesh``), as axis sizes only.

JAX builds its meshes over real or forced host devices. The port runs on
one card, so a mesh here is a :class:`ShardMesh`: axis names and sizes,
with no devices and no process group. The sharding rules, the collective
model and the planner read nothing else of a mesh. Besides JAX's
production meshes there are the two layouts of the H100: one card, and
four cards as FSDP × TP (``data`` 2 × ``model`` 2).
"""
from __future__ import annotations

import dataclasses
import math


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
