"""The evaluation service host: ``python -m repro_torch.engine.server``.

One :class:`EvalServer` turns an analytic evaluation backend into a
network service speaking the :mod:`repro_torch.engine.rpc` wire
protocol: it accepts TCP connections, performs the ``store_fingerprint``
handshake (a server only evaluates for clients whose graph / machine /
objective content-address matches its own — mismatches are *refused*,
never silently mis-served), then answers ``EVAL`` frames of canonical
``(k, 2, N)`` int32 encodings with ``RESULT`` frames of base times.

The inner evaluator is an ordinary :func:`repro_torch.engine.
make_evaluator` backend (``sim`` / ``vectorized`` / a ``pool`` of
workers; the default is ``sim``, not ``make_evaluator``'s
``wallclock``: an ``rpc`` client's objective is analytic, so a measuring
server could serve no client), so a host gets the full evaluator
contract for free: its own memo cache (a key two clients both miss is
simulated once), and — with ``--store`` — the shared persistent
:class:`~repro_torch.engine.store.EvalStore`: every host in a fleet can
point at one store file, because appends are whole O_APPEND records
(concurrent-writer safe) and duplicate keys resolve first-record-wins.
Base times only ever travel the wire — measurement noise stays
client-side, seeded per (canonical key, draw index) — so a
fleet-evaluated search is bit-identical to a local one. A server runs on
the host and creates no CUDA context.

Run a host::

    PYTHONPATH=src python -m repro_torch.engine.server \\
        --space halo3d --backend vectorized --port 9876 \\
        --store /shared/halo3d.evalstore

and point a search at the fleet::

    PYTHONPATH=src python examples/torch_schedule_search.py \\
        --space halo3d --backend rpc --hosts hostA:9876,hostB:9876

``--port 0`` binds an ephemeral port; the chosen address is printed as
the first stdout line (``repro-eval-server listening on HOST:PORT``, the
JAX package's format), which :func:`spawn_server_process` parses.
``--delay`` injects artificial per-request latency (a deterministic
straggler) for testing the client's hedging and deadline paths.

The JAX package's ``repro/engine/server.py`` with its imports rewritten,
with one change made on purpose: the server counts a refusal
(``n_refused``) before it sends the REFUSE frame, so a client that has
seen the refusal reads the count already moved. The reference counts
after sending, and a reader racing the server thread can miss it.
"""
from __future__ import annotations

import argparse
import os
import re
import socket
import subprocess
import sys
import threading
import time

from repro_torch.engine.rpc import (MSG_EVAL, MSG_HELLO, decode_eval,
                              decode_hello, encode_error, encode_refuse,
                              encode_result, encode_welcome, recv_frame,
                              send_frame, RpcProtocolError)

_LISTEN_RE = re.compile(
    r"repro-eval-server listening on (\S+:\d+)")


class EvalServer:
    """One evaluation host: a TCP front over a local backend.

    ``space`` is anything :func:`repro_torch.space.base.as_space`
    accepts; ``backend`` / ``backend_kwargs`` / ``store`` /
    ``store_path`` are forwarded to
    :func:`repro_torch.engine.make_evaluator`. ``port=0`` binds
    an ephemeral port (read :attr:`addr` after construction).
    Connections are served one thread each; evaluation is serialized
    under one lock (fleet parallelism comes from running many server
    *processes*, not threads — see :func:`spawn_server_process`).
    ``delay`` sleeps that many seconds before each evaluation, turning
    the host into a deterministic straggler for hedging tests.
    """

    def __init__(self, space, backend: str = "sim",
                 host: str = "127.0.0.1", port: int = 0,
                 machine=None, backend_kwargs: dict | None = None,
                 store=None, store_path: "str | None" = None,
                 delay: float = 0.0):
        from repro_torch.engine import make_evaluator
        from repro_torch.space.base import as_space

        self.space = as_space(space)
        kwargs = dict(backend_kwargs or {})
        if store is not None:
            kwargs["store"] = store
        if store_path is not None:
            kwargs["store_path"] = store_path
        self.backend = backend
        self.evaluator = make_evaluator(self.space, backend,
                                        machine=machine, **kwargs)
        self.delay = delay
        self._eval_lock = threading.Lock()
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(16)
        self.host, self.port = self._lsock.getsockname()[:2]
        self.addr = f"{self.host}:{self.port}"
        self._closed = False
        self._conns: set[socket.socket] = set()
        self._accept_thread: threading.Thread | None = None
        # service meters (per-host half of the fleet's QoS signal):
        self.n_connections = 0
        self.n_refused = 0
        self.n_requests = 0
        self.n_evaluated = 0

    # -- serving -------------------------------------------------------------
    def start(self) -> "EvalServer":
        """Serve in a background thread (in-process hosts for tests)."""
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        self._accept_thread = t
        return self

    def serve_forever(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                break                      # listener closed
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        self._conns.add(conn)
        self.n_connections += 1
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            mtype, body = recv_frame(conn)
            # Count each refusal before sending it: the client raises as
            # soon as the frame arrives, and must find it counted.
            if mtype != MSG_HELLO:
                self.n_refused += 1
                send_frame(conn, encode_refuse(
                    f"expected HELLO, got message type {mtype}"))
                return
            fp = decode_hello(body)
            mine = self.evaluator.store_fingerprint
            if fp != mine:
                self.n_refused += 1
                send_frame(conn, encode_refuse(
                    f"fingerprint mismatch: client {fp.hex()} vs "
                    f"server {mine.hex()} (space {self.space.name!r}, "
                    f"backend {self.backend!r}) — different graph, "
                    "machine, or objective"))
                return
            send_frame(conn, encode_welcome({
                "space": self.space.name, "backend": self.backend,
                "pid": os.getpid()}))
            while not self._closed:
                mtype, body = recv_frame(conn)
                if mtype != MSG_EVAL:
                    raise RpcProtocolError(
                        f"expected EVAL, got message type {mtype}")
                sid, enc = decode_eval(body)
                self.n_requests += 1
                try:
                    if self.delay:
                        time.sleep(self.delay)
                    candidates = self.space.decode_batch(enc)
                    with self._eval_lock:
                        times = self.evaluator.evaluate(candidates)
                except Exception as e:      # answer, don't die: the
                    send_frame(conn, encode_error(   # client retries
                        sid, f"{type(e).__name__}: {e}"))
                    continue
                self.n_evaluated += len(times)
                send_frame(conn, encode_result(sid, times))
        except (ConnectionError, OSError, RpcProtocolError):
            pass                           # client went away / garbage
        finally:
            self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """Stop accepting, reset live connections, release the backend.
        Idempotent. In-flight clients see a connection error and fail
        over (the client's retry / hedging path, not data loss)."""
        if self._closed:
            return
        self._closed = True
        try:
            self._lsock.close()
        except OSError:
            pass
        for conn in list(self._conns):
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        self.evaluator.close()

    def __enter__(self) -> "EvalServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- multi-process fleets -----------------------------------------------------

class ServerProcess:
    """Handle on a ``python -m repro_torch.engine.server`` subprocess."""

    def __init__(self, proc: subprocess.Popen, addr: str):
        self.proc = proc
        self.addr = addr

    def terminate(self) -> None:
        """Kill the host (the "server dies mid-search" event)."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)

    close = terminate

    def __enter__(self) -> "ServerProcess":
        return self

    def __exit__(self, *exc) -> None:
        self.terminate()


def spawn_server_process(space: str, *, backend: str = "sim",
                         n_streams: int | None = None,
                         store_path: "str | None" = None,
                         delay: float = 0.0, host: str = "127.0.0.1",
                         startup_timeout: float = 120.0
                         ) -> ServerProcess:
    """Launch one evaluation host as a subprocess on an ephemeral port.

    ``space`` is a registry name (``repro_torch.space.SPACES``). Blocks
    until the child prints its listen address (the child imports torch:
    seconds), then returns a handle whose ``addr`` goes straight into
    ``RpcEvaluator(hosts=[...])``. The child inherits this interpreter
    and a ``PYTHONPATH`` covering the ``repro_torch`` package, so it
    works from a source checkout.
    """
    import repro_torch

    # The import root is the directory above the package's __init__.py.
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "repro_torch.engine.server",
           "--space", space, "--backend", backend,
           "--host", host, "--port", "0"]
    if n_streams is not None:
        cmd += ["--n-streams", str(n_streams)]
    if store_path is not None:
        cmd += ["--store", store_path]
    if delay:
        cmd += ["--delay", str(delay)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                            env=env)
    deadline = time.monotonic() + startup_timeout
    line = ""
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        m = _LISTEN_RE.search(line)
        if m:
            return ServerProcess(proc, m.group(1))
    proc.terminate()
    raise RuntimeError(
        f"evaluation server for space {space!r} never announced its "
        f"address (last stdout line: {line!r})")


# -- CLI ----------------------------------------------------------------------

def main(argv: "list[str] | None" = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.engine.server",
        description="Host one analytic evaluation backend as a TCP "
                    "service speaking the repro_torch.engine.rpc "
                    "protocol.")
    ap.add_argument("--space", required=True,
                    choices=("spmv", "spmv_fine", "halo3d", "demo"),
                    help="registered design space with an analytic "
                         "model (the kernel grids have none, and their "
                         "factories allocate on the card)")
    ap.add_argument("--backend", default="sim",
                    choices=("sim", "vectorized", "pool"),
                    help="inner analytic evaluation backend (default "
                         "sim; an rpc client's objective is analytic, "
                         "so a measuring backend could serve no client)")
    ap.add_argument("--n-streams", type=int, default=None,
                    help="stream count for schedule spaces (default 2, "
                         "the paper's setting)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 binds an ephemeral port; the chosen "
                         "address is printed on the first stdout line")
    ap.add_argument("--store", default=None, metavar="PATH",
                    help="shared persistent EvalStore path (safe to "
                         "point every host in the fleet at one file)")
    ap.add_argument("--delay", type=float, default=0.0,
                    help="artificial seconds of latency per request "
                         "(a deterministic straggler, for testing "
                         "client hedging)")
    args = ap.parse_args(argv)

    from repro_torch.space import make_space

    try:
        space = make_space(args.space, n_streams=args.n_streams) \
            if args.n_streams is not None else make_space(args.space)
    except TypeError:                  # parameter grids take no streams
        space = make_space(args.space)
    server = EvalServer(space, backend=args.backend, host=args.host,
                        port=args.port, store_path=args.store,
                        delay=args.delay)
    fp = server.evaluator.store_fingerprint.hex()
    print(f"repro-eval-server listening on {server.addr} "
          f"space={server.space.name} backend={args.backend} "
          f"fingerprint={fp}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


if __name__ == "__main__":
    main()
