"""The port's evaluation service (``repro_torch.engine.{rpc,server}``)
against the JAX package's and against its own serial backend.

The first half mirrors ``tests/test_engine_rpc.py`` case by case on the
port: framing and CRC, codecs, ``parse_host``, bit-identity to ``sim``
for 1–3 hosts, accounting, the ``run_search`` dataset, noise, a host
killed mid-search, local fallback, no-fallback raising, refusal and
hedging. The second half holds the port to the reference: every message
encodes byte for byte as the reference's, a port ``rpc`` search equals
the reference's ``rpc`` search under the reference's ``Machine``, either
package's client reads the other's server, and the server counts a
refusal before the client sees it (the reference counts after sending).

Every comparison is exact: base times are float64 makespans. Servers
live on the loopback device, on ephemeral ports; every client has a
``deadline`` and a ``connect_timeout`` of at most 10 s. The file spawns
two subprocess servers in all (each imports torch).
"""
import dataclasses
import random
import socket
import time
import zlib

import numpy as np
import pytest

import repro.core as RC
import repro.engine as RE
import repro.search as RS
import repro_torch.core as C
import repro_torch.engine as E
import repro_torch.search as S
from repro.core.dag import halo3d_dag as ref_halo3d_dag
from repro.core.dag import spmv_dag_fine as ref_spmv_dag_fine
from repro.engine import rpc as ref_rpc
from repro.engine import server as ref_server_mod
from repro.engine.server import EvalServer as RefServer
from repro.search.strategy import random_schedule as ref_random_schedule
from repro_torch.core.dag import halo3d_dag, spmv_dag_fine
from repro_torch.engine import rpc
from repro_torch.engine import server as server_mod
from repro_torch.engine.server import EvalServer, spawn_server_process
from repro_torch.space import random_schedule

# Bounds on every socket wait, so no test can hang.
TIMEOUTS = {"deadline": 10.0, "connect_timeout": 5.0}


def _servers(space, n, backend="sim", **kw):
    return [EvalServer(space, backend=backend, **kw).start()
            for _ in range(n)]


def _close_all(servers):
    for s in servers:
        s.close()


def _ref_machine():
    """The reference's ``Machine()`` constants in the port's type."""
    return C.Machine(**dataclasses.asdict(RC.Machine()))


# -- wire format (tests/test_engine_rpc.py) -----------------------------------

def test_frame_roundtrip_and_crc():
    a, b = socket.socketpair()
    try:
        payload = bytes([rpc.MSG_WELCOME]) + b"{}"
        rpc.send_frame(a, payload)
        assert rpc.recv_frame(b) == (rpc.MSG_WELCOME, b"{}")
        # One flipped payload byte in an otherwise well-formed frame:
        # the CRC catches it.
        buf = bytearray(rpc._LEN.pack(len(payload)) + payload
                        + rpc._LEN.pack(zlib.crc32(payload)))
        buf[5] ^= 0xFF
        a.sendall(bytes(buf))
        with pytest.raises(rpc.RpcProtocolError, match="CRC"):
            rpc.recv_frame(b)
    finally:
        a.close()
        b.close()


def test_frame_rejects_implausible_length():
    a, b = socket.socketpair()
    try:
        a.sendall(rpc._LEN.pack(rpc.MAX_FRAME + 1))
        with pytest.raises(rpc.RpcProtocolError, match="length"):
            rpc.recv_frame(b)
    finally:
        a.close()
        b.close()


def test_message_codecs_roundtrip():
    fp = bytes(range(16))
    assert rpc.decode_hello(rpc.encode_hello(fp)[1:]) == fp
    with pytest.raises(rpc.RpcProtocolError, match="magic"):
        rpc.decode_hello(b"NOT-THE-MAGIC----" + bytes(18))

    enc = np.arange(24, dtype=np.int32).reshape(3, 2, 4)
    sid, back = rpc.decode_eval(rpc.encode_eval(7, enc)[1:])
    assert sid == 7 and back.dtype == np.dtype("<i4")
    assert np.array_equal(back, enc)

    times = [1.5, 2.25, 3.125]
    sid, got = rpc.decode_result(rpc.encode_result(9, times)[1:])
    assert sid == 9 and got.tolist() == times

    sid, msg = rpc.decode_error(rpc.encode_error(3, "boom")[1:])
    assert (sid, msg) == (3, "boom")


def test_parse_host():
    assert rpc.parse_host("127.0.0.1:9876") == ("127.0.0.1", 9876)
    assert rpc.parse_host(("h", 1)) == ("h", 1)
    with pytest.raises(ValueError):
        rpc.parse_host("no-port")


# -- bit-identity vs the serial backend ---------------------------------------

@pytest.mark.parametrize("n_servers", [1, 2, 3])
def test_rpc_bit_identical_to_serial(n_servers):
    g = halo3d_dag()
    servers = _servers(g, n_servers)
    rng = random.Random(7)
    scheds = [random_schedule(g, 2, rng) for _ in range(48)]
    try:
        with E.make_evaluator(g, "rpc", hosts=[s.addr for s in servers],
                              min_shard=1, max_inflight=2,
                              **TIMEOUTS) as ev:
            assert ev.evaluate(scheds) == [C.makespan(g, s)
                                           for s in scheds]
            assert ev.local_evals == 0
            assert sum(h["shards_done"] for h in
                       ev.rpc_stats()["hosts"].values()) > 0
    finally:
        _close_all(servers)


def test_rpc_accounting_matches_serial():
    g = spmv_dag_fine()
    servers = _servers(g, 2)
    rng = random.Random(8)
    scheds = [random_schedule(g, 2, rng) for _ in range(40)]
    batch = scheds + scheds[:10]          # duplicates -> memory hits
    ser = E.make_evaluator(g, "sim")
    try:
        with E.make_evaluator(g, "rpc", hosts=[s.addr for s in servers],
                              min_shard=1, **TIMEOUTS) as ev:
            assert ev.evaluate(batch) == ser.evaluate(batch)
            assert (ev.cache_hits, ev.cache_misses) == \
                (ser.cache_hits, ser.cache_misses)
            assert ev.stats()["backend"] == "rpc"
            assert len(ev) == len(ser)
    finally:
        _close_all(servers)


@pytest.mark.parametrize("make_strategy", [
    lambda g: S.MCTSSearch(g, 2, seed=5),
    lambda g: S.RandomSearch(g, 2, seed=5),
], ids=["mcts", "random"])
def test_run_search_rpc_byte_identical_dataset(make_strategy):
    """run_search(backend='rpc') returns byte-identical (features,
    labels, times) and budget accounting to the serial backend at equal
    sim_budget, on halo3d."""
    g = halo3d_dag()
    servers = _servers(g, 2)
    hosts = [s.addr for s in servers]
    datasets = {}
    try:
        for backend, kwargs in (
                ("sim", {}),
                ("rpc", {"hosts": hosts, "min_shard": 1, **TIMEOUTS})):
            res = S.run_search(g, make_strategy(g), budget=None,
                               sim_budget=60, batch_size=8,
                               backend=backend, backend_kwargs=kwargs)
            datasets[backend] = (res, *res.dataset())
    finally:
        _close_all(servers)
    res_a, fm_a, lab_a, t_a = datasets["sim"]
    res_b, fm_b, lab_b, t_b = datasets["rpc"]
    assert t_a.tobytes() == t_b.tobytes()
    assert fm_a.X.tobytes() == fm_b.X.tobytes()
    assert fm_a.names() == fm_b.names()
    assert np.array_equal(lab_a.labels, lab_b.labels)
    assert (res_a.cache_hits, res_a.cache_misses) == \
        (res_b.cache_hits, res_b.cache_misses)


def test_rpc_noise_identical_to_serial_noise():
    """(canonical key, draw index) noise stays client-side: only base
    times cross the wire, so noisy fleet == noisy serial exactly."""
    g = C.spmv_dag()
    servers = _servers(g, 2)
    rng = random.Random(3)
    scheds = [random_schedule(g, 2, rng) for _ in range(24)]
    try:
        with E.make_evaluator(g, "rpc", hosts=[s.addr for s in servers],
                              min_shard=1, noise_sigma=0.05,
                              noise_seed=11, **TIMEOUTS) as ev:
            noisy_rpc = ev.evaluate(scheds)
    finally:
        _close_all(servers)
    ser = E.make_evaluator(g, "sim", noise_sigma=0.05, noise_seed=11)
    assert noisy_rpc == ser.evaluate(scheds)


# -- fault tolerance ----------------------------------------------------------

class _KillerStrategy:
    """Wraps a strategy; runs ``kill`` before its ``after``-th proposal,
    the "host dies mid-search" event, injected deterministically."""

    def __init__(self, inner, kill, after):
        self.inner = inner
        self.kill = kill
        self.after = after
        self.calls = 0

    def propose(self, budget):
        self.calls += 1
        if self.calls == self.after:
            self.kill()
        return self.inner.propose(budget)

    def observe(self, schedule, time):
        self.inner.observe(schedule, time)


def test_rpc_server_killed_mid_search_identical():
    """Kill one of two servers between rounds: the run completes (the
    survivor absorbs re-queued shards) with results byte-identical to
    serial, and the dead host is marked."""
    g = halo3d_dag()
    servers = _servers(g, 2)
    try:
        ref = S.run_search(g, S.MCTSSearch(g, 2, seed=5), budget=None,
                           sim_budget=60, batch_size=8, backend="sim")
        ev = E.make_evaluator(g, "rpc", hosts=[s.addr for s in servers],
                              min_shard=1, retries=1, backoff=0.01,
                              **TIMEOUTS)
        res = S.run_search(
            g, _KillerStrategy(S.MCTSSearch(g, 2, seed=5),
                               servers[0].close, after=3),
            budget=None, sim_budget=60, batch_size=8, evaluator=ev)
        assert res.times_array().tobytes() == \
            ref.times_array().tobytes()
        assert (res.cache_hits, res.cache_misses) == \
            (ref.cache_hits, ref.cache_misses)
        stats = ev.rpc_stats()["hosts"]
        assert stats[servers[0].addr]["alive"] is False
        assert stats[servers[1].addr]["alive"] is True
        ev.close()
    finally:
        _close_all(servers)


def test_rpc_all_hosts_down_local_fallback():
    g = halo3d_dag()
    server = EvalServer(g).start()
    addr = server.addr
    server.close()                        # fleet is dead before use
    rng = random.Random(9)
    scheds = [random_schedule(g, 2, rng) for _ in range(16)]
    with E.make_evaluator(g, "rpc", hosts=[addr], min_shard=1,
                          retries=1, backoff=0.01, deadline=10.0,
                          connect_timeout=2.0) as ev:
        assert ev.evaluate(scheds) == [C.makespan(g, s) for s in scheds]
        assert ev.local_evals == len(scheds)
        assert ev.rpc_stats()["local_evals"] == len(scheds)


def test_rpc_all_hosts_down_no_fallback_raises():
    g = spmv_dag_fine()
    server = EvalServer(g).start()
    addr = server.addr
    server.close()
    rng = random.Random(10)
    scheds = [random_schedule(g, 2, rng) for _ in range(8)]
    with E.make_evaluator(g, "rpc", hosts=[addr], min_shard=1,
                          retries=0, backoff=0.01, deadline=10.0,
                          connect_timeout=2.0,
                          local_fallback=False) as ev:
        with pytest.raises(E.RpcError):
            ev.evaluate(scheds)


def test_rpc_fingerprint_mismatch_refused():
    """A server for a different space refuses the handshake, and has
    counted the refusal by the time the client raises: the count is
    read at once, with no wait."""
    g_client = halo3d_dag()
    server = EvalServer(spmv_dag_fine()).start()
    rng = random.Random(11)
    scheds = [random_schedule(g_client, 2, rng) for _ in range(8)]
    try:
        with E.make_evaluator(g_client, "rpc", hosts=[server.addr],
                              min_shard=1, **TIMEOUTS) as ev:
            with pytest.raises(E.RpcHandshakeError, match="refused"):
                ev.evaluate(scheds)
            assert server.n_refused == 1
        assert server.n_refused == 1
    finally:
        server.close()


class _AfterServer(EvalServer):
    """A server that answers its handshake only once ``after`` has
    received a shard, so ``after`` holds work in flight before this
    host can drain the queue: the order of the two client threads no
    longer decides whether a hedge happens."""

    def __init__(self, space, after: EvalServer, **kw):
        super().__init__(space, **kw)
        self.after = after

    def _serve_conn(self, conn):
        t_end = time.monotonic() + 10.0
        while self.after.n_requests == 0 and time.monotonic() < t_end:
            time.sleep(0.001)
        super()._serve_conn(conn)


def test_rpc_hedges_straggler_to_idle_host():
    """One host delays each shard by 1.5 s, far longer than the fast
    host's whole batch (16 schedules, milliseconds): the fast host
    drains the queue, then hedges the straggler's in-flight shards —
    results stay identical."""
    g = spmv_dag_fine()
    slow = EvalServer(g, delay=1.5).start()
    fast = _AfterServer(g, after=slow).start()
    rng = random.Random(12)
    scheds = [random_schedule(g, 2, rng) for _ in range(16)]
    try:
        with E.make_evaluator(g, "rpc", hosts=[slow.addr, fast.addr],
                              min_shard=1, max_inflight=2,
                              **TIMEOUTS) as ev:
            assert ev.evaluate(scheds) == [C.makespan(g, s)
                                           for s in scheds]
            hosts = ev.rpc_stats()["hosts"]
            assert hosts[fast.addr]["hedged"] >= 1
            assert ev.local_evals == 0
    finally:
        _close_all([slow, fast])


# -- the port against the reference -------------------------------------------

@pytest.mark.parametrize("encode,args", [
    ("encode_hello", (bytes(range(16)),)),
    ("encode_welcome", ({"space": "halo3d", "backend": "sim",
                         "pid": 4242},)),
    ("encode_refuse", ("fingerprint mismatch — different graph",)),
    ("encode_eval", (7, np.random.default_rng(0).integers(
        -1, 40, size=(5, 2, 17)).astype(np.int32))),
    ("encode_result", (9, np.random.default_rng(1).random(5))),
    ("encode_error", (3, "ValueError: boom")),
])
def test_messages_encode_as_the_reference(encode, args):
    ours = getattr(rpc, encode)(*args)
    assert ours == getattr(ref_rpc, encode)(*args)
    # and the frame on the wire, CRC included
    a, b = socket.socketpair()
    try:
        n = rpc.send_frame(a, ours)
        assert n == len(ours) + 8
        assert ref_rpc.recv_frame(b) == (ours[0], ours[1:])
    finally:
        a.close()
        b.close()


def test_protocol_constants_are_the_reference():
    assert rpc.RPC_MAGIC == ref_rpc.RPC_MAGIC
    assert rpc.PROTOCOL_VERSION == ref_rpc.PROTOCOL_VERSION
    assert rpc.MAX_FRAME == ref_rpc.MAX_FRAME
    for name in ("MSG_HELLO", "MSG_WELCOME", "MSG_REFUSE", "MSG_EVAL",
                 "MSG_RESULT", "MSG_ERROR"):
        assert getattr(rpc, name) == getattr(ref_rpc, name)
    assert server_mod._LISTEN_RE.pattern == \
        ref_server_mod._LISTEN_RE.pattern


@pytest.mark.parametrize("graph_fns", [
    (halo3d_dag, ref_halo3d_dag), (spmv_dag_fine, ref_spmv_dag_fine),
], ids=["halo3d", "spmv_fine"])
def test_rpc_search_equals_the_reference_rpc_search(graph_fns):
    """Two in-process servers per package, one seed, the reference's
    Machine: the port's rpc search gives the reference's (features,
    labels, times) and accounting."""
    g, g_ref = graph_fns[0](), graph_fns[1]()
    m = _ref_machine()
    ref_servers = [RefServer(g_ref).start() for _ in range(2)]
    servers = _servers(g, 2, machine=m)
    try:
        ref = RS.run_search(
            g_ref, RS.MCTSSearch(g_ref, 2, seed=5), budget=None,
            sim_budget=60, batch_size=8, backend="rpc",
            backend_kwargs={"hosts": [s.addr for s in ref_servers],
                            "min_shard": 1, **TIMEOUTS})
        res = S.run_search(
            g, S.MCTSSearch(g, 2, seed=5), budget=None, sim_budget=60,
            batch_size=8, backend="rpc", machine=m,
            backend_kwargs={"hosts": [s.addr for s in servers],
                            "min_shard": 1, **TIMEOUTS})
    finally:
        _close_all(ref_servers + servers)
    fm_r, lab_r, t_r = ref.dataset()
    fm, lab, t = res.dataset()
    assert t.tobytes() == t_r.tobytes()
    assert fm.X.tobytes() == fm_r.X.tobytes()
    assert fm.names() == fm_r.names()
    assert np.array_equal(lab.labels, lab_r.labels)
    assert (res.cache_hits, res.cache_misses) == \
        (ref.cache_hits, ref.cache_misses)


@pytest.mark.parametrize("client", ["port", "reference"])
def test_either_client_reads_the_other_packages_server(client):
    """Same magic, frames and fingerprint under the same constants: a
    port client is served by a reference server, and the other way
    round, with the serial backend's times."""
    rng = random.Random(13)
    if client == "port":
        g = halo3d_dag()
        server = RefServer(ref_halo3d_dag()).start()
        ev = E.make_evaluator(g, "rpc", hosts=[server.addr],
                              machine=_ref_machine(), min_shard=1,
                              **TIMEOUTS)
        want = E.make_evaluator(g, "sim", machine=_ref_machine())
        scheds = [random_schedule(g, 2, rng) for _ in range(24)]
    else:
        g = ref_halo3d_dag()
        server = EvalServer(halo3d_dag(), machine=_ref_machine()).start()
        ev = RE.make_evaluator(g, "rpc", hosts=[server.addr], min_shard=1,
                               **TIMEOUTS)
        want = RE.make_evaluator(g, "sim")
        scheds = [ref_random_schedule(g, 2, rng) for _ in range(24)]
    try:
        with ev:
            assert ev.evaluate(scheds) == want.evaluate(scheds)
            assert ev.local_evals == 0
    finally:
        server.close()


def test_non_hello_first_frame_is_refused_and_counted_first():
    """A connection whose first frame is not HELLO is refused, and the
    refusal is counted before the frame leaves the server."""
    g = halo3d_dag()
    server = EvalServer(g).start()
    try:
        with socket.create_connection(("127.0.0.1", server.port),
                                      timeout=10.0) as sock:
            sock.settimeout(10.0)
            rpc.send_frame(sock, rpc.encode_eval(
                0, np.zeros((1, 2, 3), np.int32)))
            mtype, body = rpc.recv_frame(sock)
            assert server.n_refused == 1
        assert mtype == rpc.MSG_REFUSE
        assert b"expected HELLO" in body
    finally:
        server.close()


def test_registry_and_lazy_server_names():
    assert E.BACKENDS["rpc"] is rpc.RpcEvaluator
    assert E.EvalServer is EvalServer
    assert E.spawn_server_process is spawn_server_process
    assert E.ServerProcess is server_mod.ServerProcess
    with pytest.raises(AttributeError):
        E.NoSuchName  # noqa: B018


@pytest.mark.parametrize("argv", [
    ["--space", "halo3d", "--backend", "wallclock"],
    ["--space", "flash_attention"],
])
def test_server_cli_serves_only_analytic_objectives(argv, capsys):
    """A measuring backend or a kernel grid could serve no rpc client
    (whose objective is analytic) and would use the card: the CLI
    refuses both before building anything."""
    with pytest.raises(SystemExit):
        server_mod.main(argv)
    assert "invalid choice" in capsys.readouterr().err


def test_subprocess_fleet_killed_mid_search_identical():
    """Two ``python -m repro_torch.engine.server`` processes (the file's
    only two), halo3d under vectorized: a cold rpc search equals local
    sim bit for bit with no local evaluation while both live, and again
    after one is killed mid-search."""
    g = halo3d_dag()
    procs = [spawn_server_process("halo3d", backend="vectorized",
                                  startup_timeout=60.0)
             for _ in range(2)]
    try:
        hosts = [p.addr for p in procs]
        ref = S.run_search(g, S.MCTSSearch(g, 2, seed=5), budget=None,
                           sim_budget=60, batch_size=8, backend="sim")
        with E.make_evaluator(g, "rpc", hosts=hosts, min_shard=1,
                              **TIMEOUTS) as ev:
            res = S.run_search(g, S.MCTSSearch(g, 2, seed=5),
                               budget=None, sim_budget=60, batch_size=8,
                               evaluator=ev)
            assert res.times_array().tobytes() == \
                ref.times_array().tobytes()
            assert ev.local_evals == 0
        with E.make_evaluator(g, "rpc", hosts=hosts, min_shard=1,
                              retries=1, backoff=0.01, **TIMEOUTS) as ev:
            res = S.run_search(
                g, _KillerStrategy(S.MCTSSearch(g, 2, seed=5),
                                   procs[0].terminate, after=3),
                budget=None, sim_budget=60, batch_size=8, evaluator=ev)
            assert res.times_array().tobytes() == \
                ref.times_array().tobytes()
            stats = ev.rpc_stats()["hosts"]
            assert stats[procs[0].addr]["alive"] is False
            assert stats[procs[1].addr]["alive"] is True
    finally:
        for p in procs:
            p.terminate()
    assert all(p.proc.poll() is not None for p in procs)
