"""Persistent content-addressed evaluation store: measurements that
outlive the process.

The paper's whole cost is measurement — MCTS explores an enormous
schedule space and every node expansion pays a wall-clock run on the
card, so the memo cache *is* the budget (§III).
:class:`~repro_torch.engine.base.EvaluatorBase` keys everything on
canonical encoding row bytes; this module adds an on-disk store keyed
by ``(fingerprint, canonical row bytes) -> time`` — so every search
(CI runs, benchmark sweeps, many users tuning the same kernel) starts
warm instead of re-measuring from zero.

The JAX package's ``repro/engine/store.py`` with its imports rewritten:
opening is a ``store.open`` telemetry span, every write a
``store.append`` span (:mod:`repro_torch.obs`).

Contracts:

* **Content-addressed.** The fingerprint (the space's
  :meth:`~repro_torch.space.base.DesignSpace.fingerprint`;
  :func:`store_fingerprint` for schedule spaces) hashes the graph's
  ops and edges or the parameter grid and its problem instance, the
  analytic :class:`~repro_torch.core.costmodel.Machine` and per-op
  durations, and the backend's objective identity (which names the
  card), so results from different spaces, machine constants, cards or
  objectives can never collide — one store file safely serves many
  searches.
* **Crash-safe, append-only.** Records are length-prefixed and
  CRC-checksummed; writers only ever append whole records with a
  single ``O_APPEND`` write, so concurrent writers interleave at
  record granularity and a crash can corrupt at most the file tail.
  :meth:`EvalStore.open`-time parsing truncates a corrupt tail and
  keeps every intact record.

File format (little-endian)::

    magic:  b"REPRO-EVALSTORE-v1\\n"
    record: u32 payload_len | payload | u32 crc32(payload)
    payload: fingerprint (16 bytes) | canonical row bytes | f64 time

Duplicate keys may appear in the file (concurrent writers racing the
same miss); the first record wins on load — all writers of a given
``(fingerprint, key)`` measured the same deterministic quantity.
"""
from __future__ import annotations

import hashlib
import os
import struct
import time
import zlib
from typing import Iterable

from repro_torch import obs
from repro_torch.core.costmodel import Machine
from repro_torch.core.dag import Graph

MAGIC = b"REPRO-EVALSTORE-v1\n"
FINGERPRINT_SIZE = 16
_LEN = struct.Struct("<I")
_TIME = struct.Struct("<d")
# payload = fingerprint + key (>= 1 encoded position = 8 bytes) + time
_MIN_PAYLOAD = FINGERPRINT_SIZE + _TIME.size


def store_fingerprint(graph: Graph, machine: Machine,
                      durations: dict[str, float],
                      objective: str) -> bytes:
    """16-byte content address of *what a stored time means* for a
    schedule space.

    Hashes everything that determines the mapping
    ``canonical row bytes -> time``: the graph's ops (all cost metadata
    — the canonical encoding only carries op *indices*, so op identity
    must come from here), its edge set, the machine constants, the
    resolved per-op duration table, and the backend's objective identity
    (``"analytic"`` for the bit-identical sim/vectorized/pool family —
    their results are interchangeable by construction, so they share a
    fingerprint and warm-start each other — vs the measuring backends'
    platform- and build-qualified keys). blake2b is stable across
    processes and ``PYTHONHASHSEED`` values.
    """
    h = hashlib.blake2b(digest_size=FINGERPRINT_SIZE)
    h.update(b"objective=" + objective.encode() + b"\n")
    h.update(repr(machine).encode() + b"\n")
    for name in sorted(graph.ops):
        op = graph.ops[name]
        h.update(repr((op.name, op.kind.value, op.flops, op.bytes_hbm,
                       op.comm_bytes, op.comm_role.value, op.duration,
                       durations.get(name))).encode())
    for u in sorted(graph.succs):
        for v in sorted(graph.succs[u]):
            h.update(f"edge {u}->{v}\n".encode())
    return h.digest()


class EvalStore:
    """Append-only on-disk memo of ``(fingerprint, key) -> base time``.

    Opening loads every intact record into memory (lookups are dict
    hits; the search hot path never touches the disk for reads) and
    truncates any corrupt tail left by a crashed writer. ``put_many``
    appends each batch with one ``write`` syscall on an ``O_APPEND``
    descriptor, so concurrent writers on a local filesystem interleave
    whole batches. Idempotent: keys already present are not re-written.
    """

    def __init__(self, path: "str | os.PathLike"):
        self.path = os.fspath(path)
        self._mem: dict[bytes, dict[bytes, float]] = {}
        self.n_records = 0
        self.n_truncated_bytes = 0
        # read/append accounting (surfaced by stats() and telemetry):
        self.n_bytes_read = 0          # file bytes parsed at open
        self.n_records_appended = 0    # records this handle wrote
        self.n_bytes_appended = 0      # bytes this handle wrote
        self.n_lookups = 0             # get() calls
        self.n_lookup_hits = 0         # get() calls that found a time
        self.lookup_seconds = 0.0      # wall inside get()
        self.append_seconds = 0.0      # wall inside put_many()
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._fd: int | None = os.open(
            self.path, os.O_RDWR | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            with obs.span("store.open", path=self.path) as sp:
                self._load()
                sp.set(records=self.n_records,
                       truncated_bytes=self.n_truncated_bytes)
        except Exception:
            os.close(self._fd)
            self._fd = None
            raise
        if self.n_truncated_bytes:
            obs.event("store.truncated_tail", path=self.path,
                      bytes=self.n_truncated_bytes)
            obs.counter("store.truncated_tails").add(1)

    # -- load / recovery ---------------------------------------------------
    def _load(self) -> None:
        size = os.fstat(self._fd).st_size
        data = os.pread(self._fd, size, 0) if size else b""
        self.n_bytes_read = len(data)
        if not data:
            os.write(self._fd, MAGIC)
            return
        if not data.startswith(MAGIC):
            raise ValueError(
                f"{self.path!r} is not an evaluation store "
                f"(bad magic {data[:8]!r})")
        off = len(MAGIC)
        end_ok = off
        n = len(data)
        while off + _LEN.size <= n:
            (plen,) = _LEN.unpack_from(data, off)
            rec_end = off + _LEN.size + plen + _LEN.size
            if plen < _MIN_PAYLOAD or rec_end > n:
                break                      # truncated / nonsense tail
            payload = data[off + _LEN.size:off + _LEN.size + plen]
            (crc,) = _LEN.unpack_from(data, rec_end - _LEN.size)
            if zlib.crc32(payload) != crc:
                break                      # corrupt tail
            fp = payload[:FINGERPRINT_SIZE]
            key = payload[FINGERPRINT_SIZE:plen - _TIME.size]
            (t,) = _TIME.unpack_from(payload, plen - _TIME.size)
            self._mem.setdefault(fp, {}).setdefault(key, t)
            self.n_records += 1
            off = end_ok = rec_end
        if end_ok < n:
            self.n_truncated_bytes = n - end_ok
            os.ftruncate(self._fd, end_ok)

    # -- lookups -----------------------------------------------------------
    def get(self, fingerprint: bytes, key: bytes) -> float | None:
        """The stored base time, or ``None`` if never measured."""
        t0 = time.perf_counter()
        bucket = self._mem.get(fingerprint)
        out = None if bucket is None else bucket.get(key)
        self.lookup_seconds += time.perf_counter() - t0
        self.n_lookups += 1
        if out is not None:
            self.n_lookup_hits += 1
        return out

    def __len__(self) -> int:
        return sum(len(b) for b in self._mem.values())

    def __contains__(self, fp_key: tuple[bytes, bytes]) -> bool:
        fp, key = fp_key
        return key in self._mem.get(fp, ())

    def fingerprints(self) -> list[bytes]:
        return list(self._mem)

    def stats(self) -> dict:
        """Traffic + recovery meter for this handle.

        Load-side: ``records_loaded`` / ``bytes_read`` (parsed at
        open) and ``truncated_bytes`` (corrupt tail dropped, 0 on a
        clean file). Write-side: ``records_appended`` /
        ``bytes_appended`` by this handle. Lookup-side: ``lookups`` /
        ``lookup_hits`` — on a warm run these mirror the evaluator's
        ``store_hits`` meter one-for-one (each distinct uncached key is
        looked up exactly once) — plus the accumulated ``lookup_seconds`` / ``append_seconds``
        walls.
        """
        return {
            "path": self.path,
            "entries": len(self),
            "fingerprints": len(self._mem),
            "records_loaded": self.n_records,
            "truncated_bytes": self.n_truncated_bytes,
            "bytes_read": self.n_bytes_read,
            "records_appended": self.n_records_appended,
            "bytes_appended": self.n_bytes_appended,
            "lookups": self.n_lookups,
            "lookup_hits": self.n_lookup_hits,
            "lookup_seconds": self.lookup_seconds,
            "append_seconds": self.append_seconds,
        }

    # -- writes ------------------------------------------------------------
    def put_many(self, fingerprint: bytes,
                 items: Iterable[tuple[bytes, float]]) -> int:
        """Append ``(key, base time)`` pairs; returns how many were new.

        Keys already present are skipped (content-addressed: the value
        is a pure function of the address). The whole batch goes out as
        one append so concurrent writers cannot interleave inside it.
        """
        if self._fd is None:
            raise ValueError(f"store {self.path!r} is closed")
        if len(fingerprint) != FINGERPRINT_SIZE:
            raise ValueError(
                f"fingerprint must be {FINGERPRINT_SIZE} bytes")
        t0 = time.perf_counter()
        bucket = self._mem.setdefault(fingerprint, {})
        buf = bytearray()
        n_new = 0
        for key, t in items:
            if key in bucket:
                continue
            t = float(t)
            bucket[key] = t
            payload = fingerprint + bytes(key) + _TIME.pack(t)
            buf += _LEN.pack(len(payload))
            buf += payload
            buf += _LEN.pack(zlib.crc32(payload))
            n_new += 1
        if buf:
            with obs.span("store.append", records=n_new,
                          bytes=len(buf)):
                os.write(self._fd, bytes(buf))
            self.n_records += n_new
            self.n_records_appended += n_new
            self.n_bytes_appended += len(buf)
        self.append_seconds += time.perf_counter() - t0
        return n_new

    def put(self, fingerprint: bytes, key: bytes, t: float) -> int:
        return self.put_many(fingerprint, [(key, t)])

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Close the file descriptor; idempotent. Reads keep working
        (the in-memory index survives); writes raise."""
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self) -> "EvalStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best-effort; context-manager close preferred
        try:
            self.close()
        except Exception:
            pass
