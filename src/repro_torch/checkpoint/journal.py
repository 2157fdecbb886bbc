"""Write-ahead op journal — ``repro.checkpoint.journal``, byte for byte.

Checkpoints bound what recovery must rebuild; the journal bounds what a
crash can lose. Every op the session acknowledges is appended here before
it is applied, so recovery is the newest complete checkpoint plus a replay
of the journaled suffix (bit-exact, since op keys are a pure function of
stream position).

Record format (little-endian), identical to the JAX package's::

    u32 MAGIC | u32 body_len | u32 crc32(body) | body
    body = u32 header_len | header JSON | payload f32 bytes | ids i32 bytes

The compact JSON header carries ``code`` (OP_*/JR_*), ``seq`` (the op
counter at append), ``cseq`` (a maintenance record's own dedup counter, see
``core/maint.py``), free-form ``aux`` and the array shapes. The journal never
interprets codes: the session's and the two-tier index's ``recover`` do.
Each record is self-delimiting and checksummed, so a torn tail or bit rot
ends the valid prefix at scan time.

fsync policy: ``"always"`` flushes and fsyncs every record; ``"flush"`` (the
default) makes appends durable when the session syncs — its acknowledgement
barrier, so nothing acknowledged is lost; ``"never"`` flushes the userspace
buffer at sync and leaves persistence to the OS.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
import zlib
from pathlib import Path
from typing import Any

import numpy as np

MAGIC = 0x4C4E524A  # "JRNL" little-endian
_REC = struct.Struct("<III")   # magic, body_len, crc32
_U32 = struct.Struct("<I")
# a larger body is framing corruption, not a record (the largest real record
# is one op of f32 rows)
_MAX_BODY = 1 << 28

FSYNC_POLICIES = ("always", "flush", "never")


@dataclasses.dataclass(frozen=True)
class JournalRecord:
    """One decoded journal record."""

    code: int
    seq: int                    # op counter at append time
    cseq: int                   # the record's replay-dedup counter
    aux: dict[str, Any]
    payload: np.ndarray | None  # f32[n, dim] (query/insert rows)
    ids: np.ndarray | None      # i32[n] (delete targets, tiered ext ids)

    @property
    def name(self) -> str:
        """Human-readable record name (``ops.JR_NAMES``/``OP_NAMES``)."""
        from repro_torch.core import ops as ops_mod

        return ops_mod.JR_NAMES.get(
            self.code, ops_mod.OP_NAMES.get(self.code, f"code{self.code}"))


def _encode(code: int, seq: int, cseq: int,
            payload: np.ndarray | None, ids: np.ndarray | None,
            aux: dict[str, Any] | None) -> bytes:
    header: dict[str, Any] = {"code": int(code), "seq": int(seq),
                              "cseq": int(cseq), "aux": aux or {}}
    p_bytes = b""
    if payload is not None:
        p = np.ascontiguousarray(payload, dtype=np.float32)
        header["p_shape"] = list(p.shape)
        p_bytes = p.tobytes()
    i_bytes = b""
    if ids is not None:
        i = np.ascontiguousarray(ids, dtype=np.int32)
        header["i_shape"] = list(i.shape)
        i_bytes = i.tobytes()
    h = json.dumps(header, separators=(",", ":")).encode()
    body = _U32.pack(len(h)) + h + p_bytes + i_bytes
    return _REC.pack(MAGIC, len(body), zlib.crc32(body)) + body


def _decode_body(body: bytes) -> JournalRecord:
    (hlen,) = _U32.unpack_from(body, 0)
    off = _U32.size
    header = json.loads(body[off:off + hlen].decode())
    off += hlen
    payload = ids = None
    if "p_shape" in header:
        shape = tuple(header["p_shape"])
        n = int(np.prod(shape, dtype=np.int64)) * 4
        payload = np.frombuffer(body[off:off + n], np.float32).reshape(shape)
        off += n
    if "i_shape" in header:
        shape = tuple(header["i_shape"])
        n = int(np.prod(shape, dtype=np.int64)) * 4
        ids = np.frombuffer(body[off:off + n], np.int32).reshape(shape)
        off += n
    if off != len(body):
        raise ValueError("journal body length mismatch")
    return JournalRecord(code=header["code"], seq=header["seq"],
                         cseq=header["cseq"], aux=header["aux"],
                         payload=payload, ids=ids)


def scan_file(path: str | Path) -> tuple[list[JournalRecord], int, int]:
    """Decode the longest valid record prefix of ``path``.

    Returns ``(records, valid_bytes, dropped_bytes)``. Never raises on
    corruption: a bad magic, an oversized length, a CRC mismatch or a torn
    final record ends the prefix. A missing file is an empty journal.
    """
    path = Path(path)
    if not path.exists():
        return [], 0, 0
    data = path.read_bytes()
    records: list[JournalRecord] = []
    off = 0
    while off + _REC.size <= len(data):
        magic, body_len, crc = _REC.unpack_from(data, off)
        if magic != MAGIC or body_len > _MAX_BODY:
            break
        start = off + _REC.size
        end = start + body_len
        if end > len(data):
            break  # torn tail: the header landed, the body did not
        body = data[start:end]
        if zlib.crc32(body) != crc:
            break
        try:
            records.append(_decode_body(body))
        except (ValueError, KeyError, TypeError, UnicodeDecodeError,
                struct.error):
            break
        off = end
    return records, off, len(data) - off


class OpJournal:
    """Appendable write-ahead log over one file.

    Opening appends without touching existing bytes: ``recover`` repairs
    the torn tail first (:meth:`repair`), a fresh session discards the old
    timeline (:meth:`reset`).
    """

    def __init__(self, path: str | Path, *, fsync: str = "flush"):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(
                f"fsync policy {fsync!r} not in {FSYNC_POLICIES}")
        self.path = Path(path)
        self.fsync_policy = fsync
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "ab")
        self.n_appended = 0

    def append(self, code: int, *, seq: int, cseq: int = 0,
               payload: np.ndarray | None = None,
               ids: np.ndarray | None = None,
               aux: dict[str, Any] | None = None) -> None:
        self._f.write(_encode(code, seq, cseq, payload, ids, aux))
        # only "always" pays a barrier per record; otherwise bytes may sit
        # in the buffer until sync() — durability is promised at the
        # acknowledgement barrier, and a partly written record at a kill is
        # the torn tail scan_file drops
        if self.fsync_policy == "always":
            self._f.flush()
            os.fsync(self._f.fileno())
        self.n_appended += 1

    def sync(self) -> None:
        """Durability barrier (no fsync only under policy ``"never"``)."""
        self._f.flush()
        if self.fsync_policy != "never":
            os.fsync(self._f.fileno())

    def truncate(self) -> None:
        """Drop every record: a published checkpoint subsumes them."""
        self._f.flush()
        self._f.truncate(0)
        self._f.seek(0)
        os.fsync(self._f.fileno())
        self.n_appended = 0

    def reset(self, *, meta: dict[str, Any] | None = None) -> None:
        """Truncate and stamp a JR_META record, which pins the session
        fingerprint so a journal never replays into another geometry."""
        from repro_torch.core import ops as ops_mod

        self.truncate()
        self.append(ops_mod.JR_META, seq=0, cseq=0, aux=meta or {})
        self._f.flush()

    def repair(self) -> tuple[list[JournalRecord], int]:
        """Scan, physically drop the torn or corrupt tail, return the
        prefix: later appends extend a clean prefix.
        Returns ``(records, dropped_bytes)``."""
        self._f.flush()
        records, valid, dropped = scan_file(self.path)
        if dropped:
            self._f.truncate(valid)
            self._f.seek(valid)
            os.fsync(self._f.fileno())
        return records, dropped

    def close(self) -> None:
        f = getattr(self, "_f", None)   # None when __init__ raised
        if f is not None and not f.closed:
            f.close()

    def __del__(self):
        self.close()
