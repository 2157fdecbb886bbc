"""Atomic checkpoints — ``repro.checkpoint.manager``, same layout on disk.

Layout::

    <dir>/step_<N:012d>/
        manifest.json   keys, n_leaves, shard_crc, extra, step, time
        shard_0.npz     leaf_<i> for every leaf, in key order
    <dir>/LATEST        atomic pointer (rename) to the newest complete step

A step is visible only after its manifest and the ``LATEST`` rename land
(no torn checkpoint after a kill); ``keep`` steps are retained; a truncated
or garbled manifest or shard raises :class:`CheckpointCorruptError`, and
``restore(None, ...)`` falls back through older complete steps.

The JAX manager names leaves by flattening a pytree; this one flattens the
port's trees to the same keys in the same order, so either package restores
the other's checkpoints: dict keys sorted, a ``GraphState`` as its 13 data
fields in declaration order under ``.<field>``, sequences by index, joined
with ``/`` (``graph/.vectors``). The arrays keep their dtypes; the caller
hands in the dtypes the JAX tree has (``base_key`` as uint32[2], the
scalars as 0-d int32). A bf16 leaf is written as its 16-bit words in the
2-byte void dtype, as ``np.save`` writes a JAX bf16 array, and comes back
so (``core.graph.graph_state_from_numpy`` reads it as bf16). A stacked
sharded state ``[S, cap, ...]`` is a tree like any other, so either
package restores the other's. JAX's ``restore(shardings=)`` places each
leaf on a mesh; on one device its counterpart is the caller's device: the
leaves come back as host arrays and the caller moves them there (for a
sharded state, ``graph_state_from_numpy(..., device=...)``), and
``distributed.elastic.reshard`` re-shards to another shard count. Across
cards the elastic restore is the rank's: one rank saves a sharded
session's ``gather_state()`` (its replica's global stack) with its
``op_counters``, and ``ShardedSession(state=<that stack>, group=...,
op_counters=...)`` on any rank count of the same mesh keeps each rank's
block and resumes the key chains, so the next ops equal the
uninterrupted run's (``testing/ranks.py::resume_checks``: 4 ranks to 2).

``timings`` holds the seconds of each step of the last save or restore
(each a full host copy of the state at 10^6 vectors): ``to_host_s``,
``savez_s``, ``save_crc_s``, ``publish_s``; ``restore_crc_s``, ``read_s``.
"""
from __future__ import annotations

import json
import shutil
import time
import zlib
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.core.graph import DATA_FIELDS, GraphState, tensor_to_numpy
from repro_torch.testing import faults


class CheckpointCorruptError(RuntimeError):
    """A step directory exists but cannot be trusted (torn or garbled)."""


def _flatten_with_paths(tree: Any) -> tuple[list[str], list[Any]]:
    """(keys, leaves) in the order ``jax.tree_util`` flattens the same tree."""
    keys: list[str] = []
    leaves: list[Any] = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, GraphState):
            for f in DATA_FIELDS:
                walk(getattr(node, f), path + ("." + f,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            keys.append("/".join(path))
            leaves.append(node)

    walk(tree, ())
    return keys, leaves


def _unflatten(like: Any, leaves: list[np.ndarray]) -> Any:
    """``like``'s structure over ``leaves``; a GraphState node comes back as
    a dict of its data fields."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, GraphState):
            return {f: next(it) for f in DATA_FIELDS}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return tensor_to_numpy(leaf)
    return np.asarray(leaf)


class CheckpointManager:
    def __init__(self, directory: str | Path, *, keep: int = 3,
                 keep_last: int | None = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        # ``keep_last`` is the retention spelling of ops configs; it wins
        self.keep = keep if keep_last is None else keep_last
        self.timings: dict[str, float] = {}

    def save(self, step: int, tree: Any, *, extra: dict | None = None) -> Path:
        keys, leaves = _flatten_with_paths(tree)
        step_dir = self.dir / f"step_{step:012d}"
        tmp_dir = self.dir / f".tmp_step_{step:012d}_{int(time.time()*1e6)}"
        tmp_dir.mkdir(parents=True)
        t0 = time.perf_counter()
        arrays = {f"leaf_{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)}
        t1 = time.perf_counter()
        np.savez(tmp_dir / "shard_0.npz", **arrays)
        del arrays
        t2 = time.perf_counter()
        shard_crc = zlib.crc32((tmp_dir / "shard_0.npz").read_bytes())
        t3 = time.perf_counter()

        # the torn-save window: data written, manifest and publish not
        faults.crash_point("mid-checkpoint-save")

        manifest = {
            "step": step,
            "keys": keys,
            "n_leaves": len(leaves),
            "shard_crc": {"shard_0.npz": shard_crc},
            "time": time.time(),
            "extra": extra or {},
        }
        (tmp_dir / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if step_dir.exists():
            shutil.rmtree(step_dir)
        tmp_dir.replace(step_dir)                      # atomic publish
        latest_tmp = self.dir / ".LATEST.tmp"
        latest_tmp.write_text(step_dir.name)
        latest_tmp.replace(self.dir / "LATEST")        # atomic pointer
        self._gc()
        self.timings = {"to_host_s": t1 - t0, "savez_s": t2 - t1,
                        "save_crc_s": t3 - t2,
                        "publish_s": time.perf_counter() - t3}
        return step_dir

    def latest_step(self) -> int | None:
        ptr = self.dir / "LATEST"
        if not ptr.exists():
            return None
        name = ptr.read_text().strip()
        if not (self.dir / name / "manifest.json").exists():
            # torn write: fall back to the newest complete step
            steps = self.all_steps()
            return steps[-1] if steps else None
        return int(name.split("_")[-1])

    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[-1])
                      for p in self.dir.glob("step_*")
                      if (p / "manifest.json").exists())

    def _load_step(self, step: int) -> tuple[dict, Any]:
        """Read and validate one step; CheckpointCorruptError on any rot."""
        step_dir = self.dir / f"step_{step:012d}"
        try:
            manifest = json.loads((step_dir / "manifest.json").read_text())
        except FileNotFoundError:
            raise CheckpointCorruptError(f"{step_dir}: no manifest")
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise CheckpointCorruptError(f"{step_dir}: bad manifest: {e}")
        shard = step_dir / "shard_0.npz"
        want_crc = manifest.get("shard_crc", {}).get("shard_0.npz")
        t0 = time.perf_counter()
        try:
            if want_crc is not None:
                got_crc = zlib.crc32(shard.read_bytes())
                if got_crc != want_crc:
                    raise CheckpointCorruptError(
                        f"{shard}: crc mismatch "
                        f"(manifest {want_crc:#x}, file {got_crc:#x})")
            data = np.load(shard)
            n = manifest.get("n_leaves")
            if n is not None and len(data.files) != n:
                raise CheckpointCorruptError(
                    f"{shard}: {len(data.files)} arrays, manifest says {n}")
        except CheckpointCorruptError:
            raise
        except FileNotFoundError:
            raise CheckpointCorruptError(f"{shard}: missing shard")
        except Exception as e:  # truncated zip, bad npy header, ...
            raise CheckpointCorruptError(f"{shard}: unreadable: {e}")
        self.timings = {"restore_crc_s": time.perf_counter() - t0}
        return manifest, data

    def restore(self, step: int | None, like: Any) -> tuple[Any, dict]:
        """Restore into the structure of ``like`` (numpy leaves).

        ``step=None`` restores the newest step that validates, falling back
        past corrupt ones; an explicit ``step`` raises
        :class:`CheckpointCorruptError` instead.
        """
        if step is not None:
            manifest, data = self._load_step(step)
        else:
            latest = self.latest_step()
            if latest is None:
                raise FileNotFoundError(f"no checkpoint in {self.dir}")
            steps = self.all_steps()
            candidates = ([s for s in steps if s <= latest]
                          + [s for s in steps if s > latest])
            errors: list[str] = []
            manifest = data = None
            for s in reversed(candidates):
                try:
                    manifest, data = self._load_step(s)
                    break
                except CheckpointCorruptError as e:
                    errors.append(str(e))
            if manifest is None:
                raise CheckpointCorruptError(
                    "every checkpoint step is corrupt:\n  "
                    + "\n  ".join(errors))

        keys, leaves = _flatten_with_paths(like)
        if keys != manifest["keys"]:
            raise ValueError(
                "checkpoint tree mismatch:\n"
                f"  saved:   {manifest['keys'][:5]}...\n"
                f"  restore: {keys[:5]}...")
        t0 = time.perf_counter()
        with data:
            new_leaves = [data[f"leaf_{i}"] for i in range(len(leaves))]
        self.timings["read_s"] = time.perf_counter() - t0
        return _unflatten(like, new_leaves), manifest["extra"]

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:012d}", ignore_errors=True)
