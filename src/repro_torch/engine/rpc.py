"""Evaluation as a service: the RPC wire protocol + the ``rpc`` backend.

MCTS explores far more implementations than one host can evaluate.
:mod:`repro_torch.engine.pool` already ships canonical-unique misses as
compact ``(k, 2, N)`` int32 encodings with the cache / meters / noise
kept parent-side; this module puts that exact payload on a TCP socket
so the "workers" can be evaluator *hosts* anywhere
(:mod:`repro_torch.engine.server` is the other half), while everything
search-visible stays in the client:

* **Wire format.** Length-prefixed, CRC-framed binary messages reusing
  the store's record framing (:mod:`repro_torch.engine.store`)::

      frame:   u32 payload_len | payload | u32 crc32(payload)
      payload: u8 msg_type | body

  Message bodies (little-endian): ``HELLO`` carries the protocol magic
  + version + the client's 16-byte ``store_fingerprint``; the server
  answers ``WELCOME`` (JSON info) or ``REFUSE`` (reason) — a server
  only ever evaluates for clients whose graph/machine/objective
  fingerprint matches its own, so results can never silently alias.
  ``EVAL`` is ``u32 shard_id | u8 ndim | u32 dims[ndim] | int32 data``
  — the canonical encoding rows exactly as :meth:`~repro_torch.space.
  base.DesignSpace.encode_batch` produced them; ``RESULT`` is
  ``u32 shard_id | f64 times[k]``. Corrupt frames raise
  :class:`RpcProtocolError` and count as a host failure, never as data.
  The magic, the frames and every message are byte for byte the JAX
  package's (``repro/engine/rpc.py``), so either package's frames read
  the same.

* **Pipelined dispatch.** :class:`RpcEvaluator` splits each miss batch
  into contiguous shards and keeps up to ``max_inflight`` shards in
  flight *per connection* (requests are sent back-to-back before the
  first response is read), across all hosts at once. Responses are
  matched by shard index, and shards partition the batch in
  first-appearance order — so the assembled result list, and therefore
  the ``(features, labels, times)`` dataset and budget accounting, is
  **bit-identical** to the serial backend no matter how many hosts
  raced or in what order they answered.

* **Fault tolerance.** Each shard dispatch runs under a ``deadline``;
  a timeout, connection drop, or protocol error re-queues the host's
  un-answered shards (bounded by ``retries`` re-dispatches per shard,
  exponential ``backoff`` per host), an idle host *hedges* straggler
  shards that are still in flight elsewhere (first result wins — both
  computed the same deterministic base time), and when every host is
  down the remaining shards degrade gracefully to local serial
  evaluation (``local_fallback=True``), so a search never dies with
  its fleet.

* **Observability.** ``rpc.send`` / ``rpc.recv`` / ``rpc.retry``
  spans and per-host byte + latency counters land in
  :mod:`repro_torch.obs`, and :meth:`RpcEvaluator.rpc_stats` exposes the
  same numbers as a dict — together with the evaluator's three-way
  ``{memory_hits, store_hits, misses}`` meter this is the service's
  billing / QoS signal.

**Why the service stays on the host.** The ``rpc`` objective is
analytic by construction: its objective key is the base class's
``"analytic"``, a server refuses any client whose fingerprint (which
hashes that key) differs from its own, and the local fallback is the
space's analytic model. So ``rpc`` takes no ``device`` and never touches
CUDA, like ``sim``, ``vectorized`` and ``pool``; it is not measured on
the card, and a server hosting a measuring backend can serve no client.

The server half (:mod:`repro_torch.engine.server`) hosts an analytic
backend (``sim`` / ``vectorized`` / a worker pool) behind the same
handshake, and every host can share one :class:`~repro_torch.engine.
store.EvalStore` — O_APPEND whole-record writes are concurrent-writer
safe.

The JAX package's ``repro/engine/rpc.py`` with its imports rewritten.
"""
from __future__ import annotations

import json
import socket
import struct
import threading
import time
import zlib
from collections import deque
from typing import Sequence

import numpy as np

from repro_torch import obs
from repro_torch.core.costmodel import Machine
from repro_torch.core.dag import Graph, Schedule
from repro_torch.engine.base import EvaluatorBase
from repro_torch.engine.store import FINGERPRINT_SIZE

RPC_MAGIC = b"REPRO-EVALRPC-v1\n"
PROTOCOL_VERSION = 1

MSG_HELLO = 1       # client -> server: magic | u16 version | fingerprint
MSG_WELCOME = 2     # server -> client: utf-8 JSON server info
MSG_REFUSE = 3      # server -> client: utf-8 reason (handshake rejected)
MSG_EVAL = 4        # client -> server: u32 shard | u8 ndim | dims | int32
MSG_RESULT = 5      # server -> client: u32 shard | f64 times
MSG_ERROR = 6       # server -> client: u32 shard | utf-8 message

_LEN = struct.Struct("<I")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
# A frame longer than this is garbage, not a batch (the biggest real
# shard is a few MB of int32 encodings).
MAX_FRAME = 1 << 30


class RpcError(RuntimeError):
    """Base class for evaluation-service failures."""


class RpcProtocolError(RpcError):
    """Malformed frame: bad length, CRC mismatch, unknown message."""


class RpcHandshakeError(RpcError):
    """The server refused the fingerprint handshake — the client and
    server disagree about graph / machine / objective. This is a
    configuration error, never retried."""


# -- framing ------------------------------------------------------------------

def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise ``ConnectionError`` on EOF."""
    chunks = []
    got = 0
    while got < n:
        b = sock.recv(n - got)
        if not b:
            raise ConnectionError("peer closed mid-frame")
        chunks.append(b)
        got += len(b)
    return b"".join(chunks)


def send_frame(sock: socket.socket, payload: bytes) -> int:
    """Write one CRC-framed message; returns bytes put on the wire."""
    buf = _LEN.pack(len(payload)) + payload + _LEN.pack(zlib.crc32(payload))
    sock.sendall(buf)
    return len(buf)


def recv_frame(sock: socket.socket) -> tuple[int, bytes]:
    """Read one framed message -> ``(msg_type, body)``; CRC-checked."""
    (plen,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if not 1 <= plen <= MAX_FRAME:
        raise RpcProtocolError(f"implausible frame length {plen}")
    payload = _recv_exact(sock, plen)
    (crc,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if zlib.crc32(payload) != crc:
        raise RpcProtocolError("frame CRC mismatch")
    return payload[0], payload[1:]


# -- message encode / decode --------------------------------------------------

def encode_hello(fingerprint: bytes) -> bytes:
    if len(fingerprint) != FINGERPRINT_SIZE:
        raise ValueError(f"fingerprint must be {FINGERPRINT_SIZE} bytes")
    return (bytes([MSG_HELLO]) + RPC_MAGIC
            + _U16.pack(PROTOCOL_VERSION) + fingerprint)


def decode_hello(body: bytes) -> bytes:
    """-> the client's fingerprint; raises on bad magic / version."""
    m = len(RPC_MAGIC)
    if body[:m] != RPC_MAGIC:
        raise RpcProtocolError(f"bad hello magic {body[:8]!r}")
    (version,) = _U16.unpack_from(body, m)
    if version != PROTOCOL_VERSION:
        raise RpcProtocolError(f"unsupported protocol version {version}")
    fp = body[m + _U16.size:]
    if len(fp) != FINGERPRINT_SIZE:
        raise RpcProtocolError(f"hello fingerprint is {len(fp)} bytes")
    return fp


def encode_welcome(info: dict) -> bytes:
    return bytes([MSG_WELCOME]) + json.dumps(info).encode()


def encode_refuse(reason: str) -> bytes:
    return bytes([MSG_REFUSE]) + reason.encode()


def encode_eval(shard_id: int, enc: np.ndarray) -> bytes:
    enc = np.ascontiguousarray(enc, dtype="<i4")
    dims = enc.shape
    return (bytes([MSG_EVAL]) + _U32.pack(shard_id) + bytes([len(dims)])
            + b"".join(_U32.pack(d) for d in dims) + enc.tobytes())


def decode_eval(body: bytes) -> tuple[int, np.ndarray]:
    (shard_id,) = _U32.unpack_from(body, 0)
    ndim = body[_U32.size]
    off = _U32.size + 1
    dims = []
    for _ in range(ndim):
        (d,) = _U32.unpack_from(body, off)
        dims.append(d)
        off += _U32.size
    n_vals = int(np.prod(dims, dtype=np.int64)) if dims else 0
    if len(body) - off != 4 * n_vals:
        raise RpcProtocolError(
            f"eval body carries {len(body) - off} data bytes for "
            f"shape {tuple(dims)}")
    enc = np.frombuffer(body, dtype="<i4", count=n_vals,
                        offset=off).reshape(dims)
    return shard_id, enc


def encode_result(shard_id: int, times: Sequence[float]) -> bytes:
    arr = np.ascontiguousarray(times, dtype="<f8")
    return bytes([MSG_RESULT]) + _U32.pack(shard_id) + arr.tobytes()


def decode_result(body: bytes) -> tuple[int, np.ndarray]:
    (shard_id,) = _U32.unpack_from(body, 0)
    if (len(body) - _U32.size) % 8:
        raise RpcProtocolError("result body is not whole float64s")
    times = np.frombuffer(body, dtype="<f8", offset=_U32.size)
    return shard_id, times


def encode_error(shard_id: int, message: str) -> bytes:
    return bytes([MSG_ERROR]) + _U32.pack(shard_id) + message.encode()


def decode_error(body: bytes) -> tuple[int, str]:
    (shard_id,) = _U32.unpack_from(body, 0)
    return shard_id, body[_U32.size:].decode(errors="replace")


def parse_host(spec) -> tuple[str, int]:
    """``"host:port"`` (or an ``(host, port)`` pair) -> ``(host, port)``."""
    if isinstance(spec, (tuple, list)) and len(spec) == 2:
        return str(spec[0]), int(spec[1])
    host, _, port = str(spec).rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"host spec {spec!r} is not 'host:port'")
    return host, int(port)


# -- client-side dispatch machinery -------------------------------------------

class _Host:
    """One evaluator host: address, persistent connection, QoS meters."""

    def __init__(self, spec):
        self.addr = parse_host(spec)
        self.name = f"{self.addr[0]}:{self.addr[1]}"
        self.sock: socket.socket | None = None
        self.alive = True
        self.failures = 0        # consecutive failures (reset on success)
        # per-host QoS / billing meters (mirrored into repro_torch.obs):
        self.shards_done = 0
        self.hedged = 0
        self.retries = 0
        self.bytes_sent = 0
        self.bytes_recv = 0
        self.send_seconds = 0.0
        self.recv_seconds = 0.0

    def stats(self) -> dict:
        return {
            "alive": self.alive,
            "shards_done": self.shards_done,
            "hedged": self.hedged,
            "retries": self.retries,
            "bytes_sent": self.bytes_sent,
            "bytes_recv": self.bytes_recv,
            "send_seconds": self.send_seconds,
            "recv_seconds": self.recv_seconds,
        }

    def drop(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None


class _ShardTable:
    """Shared bookkeeping for one miss batch's shards.

    ``pending`` holds shard ids awaiting a first (or re-) dispatch;
    ``inflight`` maps a shard to the hosts currently computing it
    (more than one when hedged); ``results`` collects first-result-wins
    times; ``failed`` holds shards whose retry budget ran out (they go
    to the local fallback). All transitions happen under one lock so
    worker threads never double-count an attempt or lose a release.
    """

    def __init__(self, n_shards: int, max_attempts: int):
        self.n = n_shards
        self.max_attempts = max_attempts
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.pending: deque[int] = deque(range(n_shards))
        self.attempts = [0] * n_shards
        self.inflight: dict[int, set[str]] = {}
        self.results: dict[int, np.ndarray] = {}
        self.failed: set[int] = set()

    def settled(self) -> bool:
        with self.lock:
            return len(self.results) + len(self.failed) >= self.n

    def claim(self, host: str, want: int,
              hedge: bool) -> tuple[list[int], bool]:
        """Take up to ``want`` pending shards for ``host``; with an
        empty queue and ``hedge``, steal one straggler still in flight
        elsewhere. Returns ``(shard_ids, was_hedged)``."""
        with self.cond:
            sids: list[int] = []
            while self.pending and len(sids) < want:
                sid = self.pending.popleft()
                if sid in self.results or sid in self.failed:
                    continue
                self.attempts[sid] += 1
                self.inflight.setdefault(sid, set()).add(host)
                sids.append(sid)
            if sids:
                return sids, False
            if hedge:
                for sid, owners in self.inflight.items():
                    if (sid not in self.results and sid not in self.failed
                            and host not in owners
                            and self.attempts[sid] < self.max_attempts):
                        self.attempts[sid] += 1
                        owners.add(host)
                        return [sid], True
            return [], False

    def complete(self, host: str, sid: int, times: np.ndarray) -> None:
        with self.cond:
            owners = self.inflight.get(sid)
            if owners is not None:
                owners.discard(host)
                if not owners:
                    self.inflight.pop(sid, None)
            # First result wins; a hedged duplicate computed the same
            # deterministic base times, so dropping it changes nothing.
            if sid not in self.results:
                self.results[sid] = times
            self.cond.notify_all()

    def release(self, host: str, sids: Sequence[int]) -> None:
        """Give back shards a failed host never answered: re-queue each
        (unless another host still carries it, or the retry budget is
        spent — then it lands in ``failed`` for the local fallback)."""
        with self.cond:
            for sid in sids:
                owners = self.inflight.get(sid)
                if owners is not None:
                    owners.discard(host)
                if sid in self.results or sid in self.failed:
                    continue
                if owners:           # hedge partner still computing it
                    continue
                self.inflight.pop(sid, None)
                if self.attempts[sid] >= self.max_attempts:
                    self.failed.add(sid)
                else:
                    self.pending.append(sid)
            self.cond.notify_all()

    def wait_for_change(self, timeout: float) -> None:
        with self.cond:
            if len(self.results) + len(self.failed) < self.n:
                self.cond.wait(timeout)


class RpcEvaluator(EvaluatorBase):
    """The ``rpc`` backend: shard miss batches across evaluator hosts.

    ``hosts`` is a list of ``"host:port"`` strings (or ``(host, port)``
    pairs) running :mod:`repro_torch.engine.server`. The client keeps one
    persistent connection per host, pipelines up to ``max_inflight``
    shards per connection, retries failed dispatches (``retries`` times
    per shard, exponential ``backoff`` per host, ``deadline`` seconds
    per in-flight read), hedges stragglers onto idle hosts, and — with
    ``local_fallback`` (the default) — evaluates any shard the fleet
    could not serve with the space's analytic model locally, so the
    search completes even with every host down. Results are assembled
    by shard index, preserving first-appearance order: an ``rpc``
    search is byte-identical to ``sim`` regardless of host count,
    failures, or hedging (locked by tests/test_torch_rpc.py).
    """

    backend = "rpc"

    def __init__(self, graph: "Graph", machine: Machine | None = None,
                 noise_sigma: float = 0.0, noise_seed: int = 0,
                 hosts: Sequence = (), max_inflight: int = 4,
                 min_shard: int = 8, retries: int = 2,
                 deadline: float = 30.0, backoff: float = 0.05,
                 connect_timeout: float = 5.0, hedge: bool = True,
                 local_fallback: bool = True, **base_kwargs):
        super().__init__(graph, machine, noise_sigma, noise_seed,
                         **base_kwargs)
        self.hosts = [_Host(h) for h in hosts]
        seen: set[str] = set()
        for h in self.hosts:
            if h.name in seen:
                raise ValueError(f"duplicate host {h.name!r}")
            seen.add(h.name)
        self.max_inflight = max(1, max_inflight)
        self.min_shard = max(1, min_shard)
        self.retries = max(0, retries)
        self.deadline = deadline
        self.backoff = backoff
        self.connect_timeout = connect_timeout
        self.hedge = hedge
        self.local_fallback = local_fallback
        self.local_evals = 0     # shard rows served by the fallback
        self._handshake_error: RpcHandshakeError | None = None

    # -- connections --------------------------------------------------------
    def _ensure_conn(self, host: _Host) -> socket.socket:
        """The host's persistent connection, performing the fingerprint
        handshake on first use. ``OSError`` means the host is (for now)
        unreachable; :class:`RpcHandshakeError` means it is
        *misconfigured* and must not be retried."""
        if host.sock is not None:
            return host.sock
        sock = socket.create_connection(host.addr,
                                        timeout=self.connect_timeout)
        try:
            sock.settimeout(self.deadline)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            send_frame(sock, encode_hello(self.store_fingerprint))
            mtype, body = recv_frame(sock)
            if mtype == MSG_REFUSE:
                raise RpcHandshakeError(
                    f"server {host.name} refused: "
                    f"{body.decode(errors='replace')}")
            if mtype != MSG_WELCOME:
                raise RpcProtocolError(
                    f"expected WELCOME from {host.name}, got {mtype}")
        except BaseException:
            sock.close()
            raise
        host.sock = sock
        return sock

    # -- the dispatch loop ---------------------------------------------------
    def _host_worker(self, host: _Host, table: _ShardTable,
                     shards: list[np.ndarray]) -> None:
        while not table.settled():
            sids, hedged = table.claim(host.name, self.max_inflight,
                                       self.hedge)
            if not sids:
                table.wait_for_change(0.02)
                continue
            try:
                sock = self._ensure_conn(host)
            except RpcHandshakeError as e:
                self._handshake_error = e
                host.alive = False
                table.release(host.name, sids)
                return
            except (OSError, RpcError):
                host.failures += 1
                table.release(host.name, sids)
                if host.failures > self.retries:
                    host.alive = False
                    return
                with obs.span("rpc.retry", host=host.name, phase="connect",
                              failures=host.failures):
                    time.sleep(self.backoff * (2 ** (host.failures - 1)))
                continue
            if hedged:
                host.hedged += len(sids)
                obs.counter("rpc.hedges").add(len(sids))
            outstanding = list(sids)
            try:
                # Pipelined dispatch: every claimed shard goes on the
                # wire before the first response is read.
                for sid in sids:
                    payload = encode_eval(sid, shards[sid])
                    t0 = time.perf_counter()
                    with obs.span("rpc.send", host=host.name, shard=sid,
                                  n=len(shards[sid])):
                        nb = send_frame(sock, payload)
                    host.send_seconds += time.perf_counter() - t0
                    host.bytes_sent += nb
                    obs.counter(f"rpc.bytes_sent[{host.name}]").add(nb)
                while outstanding:
                    with table.lock:
                        live = [s for s in outstanding
                                if s not in table.results]
                    if not live:
                        # Everything left was hedge-completed elsewhere;
                        # abandon the connection rather than wait out a
                        # straggler (stale responses die with the
                        # socket — shard ids never cross batches).
                        host.drop()
                        outstanding = []
                        break
                    t0 = time.perf_counter()
                    with obs.span("rpc.recv", host=host.name) as sp:
                        mtype, body = recv_frame(sock)
                        sp.set(bytes=len(body))
                    host.recv_seconds += time.perf_counter() - t0
                    host.bytes_recv += len(body) + 2 * _LEN.size + 1
                    obs.counter(f"rpc.bytes_recv[{host.name}]").add(
                        len(body) + 2 * _LEN.size + 1)
                    if mtype == MSG_ERROR:
                        sid, msg = decode_error(body)
                        raise RpcError(
                            f"server {host.name} failed shard {sid}: "
                            f"{msg}")
                    if mtype != MSG_RESULT:
                        raise RpcProtocolError(
                            f"unexpected message type {mtype}")
                    sid, times = decode_result(body)
                    if sid in outstanding:
                        outstanding.remove(sid)
                        if len(times) != len(shards[sid]):
                            raise RpcProtocolError(
                                f"shard {sid}: {len(times)} times for "
                                f"{len(shards[sid])} rows")
                        host.shards_done += 1
                        table.complete(host.name, sid, times)
                    # else: a response for a shard this worker released
                    # in an earlier life of the connection — impossible
                    # (failures drop the socket), but harmless to skip.
            except (OSError, ConnectionError, RpcProtocolError,
                    RpcError):
                host.drop()
                host.failures += 1
                host.retries += 1
                obs.counter("rpc.retries").add(1)
                table.release(host.name, outstanding)
                if host.failures > self.retries:
                    host.alive = False
                    return
                with obs.span("rpc.retry", host=host.name, phase="io",
                              shards=len(outstanding),
                              failures=host.failures):
                    time.sleep(self.backoff * (2 ** (host.failures - 1)))
            else:
                host.failures = 0

    def _measure_local(self, schedules: Sequence[Schedule]) -> list[float]:
        return [self.space.analytic_cost(s, self.machine, self._durations)
                for s in schedules]

    def _measure_batch(self, schedules: Sequence[Schedule],
                       encoded: np.ndarray | None = None) -> list[float]:
        if self._handshake_error is not None:
            raise self._handshake_error
        n = len(schedules)
        alive = [h for h in self.hosts if h.alive]
        if not alive or encoded is None:
            if self.hosts and not self.local_fallback:
                raise RpcError("every evaluation host is down and "
                               "local_fallback is disabled")
            self.local_evals += n
            return self._measure_local(schedules)

        # Contiguous shards in first-appearance order; enough of them
        # to keep every connection's pipeline full, but never smaller
        # than min_shard (framing would cost more than simulation).
        n_shards = max(1, min(n // self.min_shard,
                              len(alive) * self.max_inflight * 2))
        bounds = [n * k // n_shards for k in range(n_shards + 1)]
        shards = [encoded[bounds[k]:bounds[k + 1]]
                  for k in range(n_shards)]

        table = _ShardTable(n_shards, max_attempts=self.retries + 1)
        workers = [threading.Thread(target=self._host_worker,
                                    args=(h, table, shards), daemon=True)
                   for h in alive]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        if self._handshake_error is not None and len(table.results) < \
                n_shards:
            raise self._handshake_error

        missing = [sid for sid in range(n_shards)
                   if sid not in table.results]
        if missing:
            if not self.local_fallback:
                raise RpcError(
                    f"{len(missing)} shard(s) unserved after retries "
                    "and local_fallback is disabled")
            obs.event("rpc.local_fallback", shards=len(missing))
            for sid in missing:
                rows = self._measure_local(
                    schedules[bounds[sid]:bounds[sid + 1]])
                self.local_evals += len(rows)
                table.results[sid] = np.asarray(rows, dtype=np.float64)

        out: list[float] = []
        for sid in range(n_shards):
            out.extend(float(t) for t in table.results[sid])
        return out

    # -- QoS / lifecycle -----------------------------------------------------
    def rpc_stats(self) -> dict:
        """Per-host service meters: shards / bytes / walls / retries /
        hedges, plus the rows the local fallback absorbed. Pair with
        :meth:`stats` (hit/miss traffic) for the full billing signal."""
        return {
            "hosts": {h.name: h.stats() for h in self.hosts},
            "local_evals": self.local_evals,
        }

    def close(self) -> None:
        for h in self.hosts:
            h.drop()
        super().close()
