"""The port's wire (``repro_torch.dist.net`` and ``transport``) against the
JAX package's.

* For equal payload, mid and ts, ``encode_frame`` gives equal bytes in both
  packages, and each package's ``FrameDecoder`` / ``safe_loads`` reads the
  other's frames.
* The forbidden-global, CRC, oversize and duplicate-mid cases behave as
  ``tests/test_transport.py`` and ``tests/test_dist_net.py`` expect of the
  reference; a torch tensor in a payload is a forbidden global.
* Pipe teardown races never raise; over TCP a spawned worker round-trips
  messages with wire stamps, a stale incarnation is refused at the
  handshake, and a hostile frame drops the socket, not the process.

This module keeps torch and the JAX package out of its top-level imports:
spawned echo workers import it.
"""

import pickle
import socket
import struct
import time

import numpy as np
import pytest

from repro_torch.dist import net as tnet
from repro_torch.dist.transport import start_worker, start_workers, stop_workers

MSGS = [
    {"kind": "round", "t": 3, "attempt": 0, "items": [
        {"key": ("ell", 2, 1), "job": 2, "chunks": [1, 2], "coeffs": [1.0, -0.5]}],
     "delay_s": 0.03, "_sent": 12.5},
    {"kind": "result", "t": 3, "attempt": 1, "worker": 1,
     "values": [(("d2", 2, 0, 1), np.arange(12, dtype=np.float32).reshape(3, 4))],
     "telemetry": {"recv": 1.0, "delay_s": 0.0, "compute_s": 0.5, "wire_s": None,
                   "sent": 2.0}},
    {"kind": "__hello__", "worker": 0, "incarnation": 2},
    {"kind": "pong", "seq": None, "extras": [1, 2.5, "s", (7,), np.float64(0.5),
                                             np.array([True, False])]},
]


@pytest.fixture(scope="module")
def rnet():
    from repro.dist import net

    return net


def _equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("k", range(len(MSGS)))
@pytest.mark.parametrize("mid,ts", [(1, 0.0), (7, 1.5), (2**62, 123456.789)])
def test_frames_equal_and_read_both_ways(rnet, k, mid, ts):
    payload = pickle.dumps(MSGS[k])
    frame = tnet.encode_frame(payload, mid, ts)
    assert frame == rnet.encode_frame(payload, mid, ts)
    for dec, loads in ((tnet.FrameDecoder(), rnet.safe_loads),
                       (rnet.FrameDecoder(), tnet.safe_loads)):
        got = []
        for i in range(0, len(frame), 13):      # fragmented stream
            got += dec.feed(frame[i:i + 13])
        assert [(p, m, t) for p, m, t in got] == [(payload, mid, ts)]
        assert _equal(loads(got[0][0]), MSGS[k])


def test_header_and_bounds_are_the_reference(rnet):
    assert tnet._HEADER.format == rnet._HEADER.format == "!2sIQdI"
    assert tnet._HEADER.size == 2 + 4 + 8 + 8 + 4
    assert tnet.MAX_FRAME == rnet.MAX_FRAME == 64 * 1024 * 1024
    assert tnet.MAGIC == rnet.MAGIC
    assert tnet._SAFE_BUILTINS == rnet._SAFE_BUILTINS
    assert tnet._NUMPY_SCALARS == rnet._NUMPY_SCALARS
    assert tnet._NUMPY_RECON_MODULES == rnet._NUMPY_RECON_MODULES


class _Gadget:
    def __reduce__(self):
        import os

        return (os.system, ("true",))


def test_forbidden_globals_raise_frameerror_in_both(rnet):
    import torch

    for payload in (pickle.dumps({"kind": "round", "x": _Gadget()}),
                    pickle.dumps(time.sleep),
                    pickle.dumps({"kind": "result", "values": [("k", torch.ones(3))]})):
        for net in (tnet, rnet):
            with pytest.raises(net.FrameError, match="forbidden global"):
                net.safe_loads(payload)
    truncated = pickle.dumps({"kind": "ready", "worker": 3})
    for net in (tnet, rnet):
        with pytest.raises(net.FrameError):
            net.safe_loads(truncated[: len(truncated) // 2])


@pytest.mark.parametrize("seed", range(6))
def test_corrupted_byte_is_caught_by_both(rnet, seed):
    rng = np.random.default_rng(seed)
    payload = rng.bytes(int(rng.integers(1, 400)))
    wire = bytearray(tnet.encode_frame(payload, 3, 2.0))
    pos = int(rng.integers(0, len(wire)))
    wire[pos] ^= 0x41
    outcomes = []
    for net in (tnet, rnet):
        try:
            frames = net.FrameDecoder().feed(bytes(wire))
        except net.FrameError:
            outcomes.append("error")
            continue
        # a flipped length may leave the decoder waiting: nothing delivered
        assert all((p, m) != (payload, 3) for p, m, _ in frames)
        outcomes.append(len(frames))
    assert outcomes[0] == outcomes[1]


def test_crc_oversize_and_magic_raise(rnet):
    for net in (tnet, rnet):
        good = net.encode_frame(b"x" * 10, 1, 0.0)
        bad = bytearray(good)
        bad[-1] ^= 1                              # payload byte: crc mismatch
        with pytest.raises(net.FrameError, match="crc"):
            net.FrameDecoder().feed(bytes(bad))
        with pytest.raises(net.FrameError):
            net.encode_frame(b"\0" * (net.MAX_FRAME + 1), 1, 0.0)
        forged = bytearray(good)
        forged[2:6] = struct.pack("!I", net.MAX_FRAME + 1)
        with pytest.raises(net.FrameError, match="exceeds bound"):
            net.FrameDecoder().feed(bytes(forged))
        with pytest.raises(net.FrameError, match="bad magic"):
            net.FrameDecoder().feed(b"XX" + bytes(good[2:]))


@pytest.mark.parametrize("seed", range(4))
def test_duplicate_and_reordered_mids_accepted_once_in_both(rnet, seed):
    rng = np.random.default_rng(seed)
    mids = list(range(1, 31))
    stream = mids + [m for m in mids if m % (seed + 2) == 0]
    rng.shuffle(stream)
    got = []
    for net in (tnet, rnet):
        filt = net.MidFilter()
        accepted = [m for m in stream if filt.accept(m)]
        assert sorted(accepted) == mids
        assert not any(filt.accept(m) for m in stream)
        assert len(filt._seen) == 0
        got.append(accepted)
    assert got[0] == got[1]


def test_linear_worker_import_chain_leaves_out_torch():
    """A spawned linear-mode worker imports the worker module through the
    package: neither pulls in torch (nor the JAX package)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys, pickle\n"
            "from repro_torch.dist import WorkerSetup, FaultSpec, worker_main\n"
            "setup = pickle.loads(pickle.dumps(WorkerSetup(0, 1, bounds=((0, 64),), fault=FaultSpec())))\n"
            "setup.computer().value({'job': 1, 'chunks': [0], 'coeffs': [1.0]})\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'repro')]\n"
            "assert not bad, bad\n")
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(src)}, timeout=120)
    assert out.returncode == 0, out.stderr


# -- live transports ---------------------------------------------------------


def _echo_worker(conn, setup):
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return
        if msg.get("kind") == "stop":
            return
        conn.send({"kind": "result", "echo": msg.get("payload", msg)})


def _wait_recv(link, timeout=20.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        msg = link.try_recv()
        if msg is not None:
            return msg
        time.sleep(0.01)
    raise AssertionError("no message within timeout")


def _wait_attached(link, timeout=20.0):
    deadline = time.perf_counter() + timeout
    while link.waitable() is None:
        assert time.perf_counter() < deadline, "worker never connected"
        time.sleep(0.01)


def test_pipe_teardown_races_never_raise():
    links = start_workers(3, _echo_worker, lambda i: {"worker_id": i})
    try:
        assert links[0].send({"kind": "round", "payload": 5})
        assert _wait_recv(links[0])["echo"] == 5
        links[1].process.kill()
        links[1].process.join(5.0)
        for _ in range(3):
            links[1].drain()
            links[1].try_recv()
        assert links[1].send({"kind": "round", "t": 2}) is False
        assert links[1].broken
        links[2].conn.close()
        assert links[2].send({"kind": "round", "t": 1}) is False
    finally:
        stop_workers(links)
        stop_workers(links)                      # idempotent
    for lk in links:
        lk.process.join(5.0)
        assert not lk.process.is_alive()
    lk = start_worker(3, _echo_worker, {})
    lk.kill()
    assert lk.broken and not lk.alive()
    lk.kill()
    lk.stop()


def test_tcp_echo_roundtrip_with_wire_timestamps():
    host = tnet.TcpHost()
    link = tnet.start_worker_tcp(host, 0, _echo_worker, {})
    try:
        _wait_attached(link)
        assert link.send({"kind": "round", "payload": 42})
        msg = _wait_recv(link)
        assert msg["echo"] == 42
        assert 0 <= msg["_wire_lag"] < 5.0
        assert link.peer_alive()
        # a numpy value crosses the wire both ways
        assert link.send({"kind": "round", "payload": np.arange(5.0)})
        np.testing.assert_array_equal(_wait_recv(link)["echo"], np.arange(5.0))
    finally:
        link.stop()
        host.close()


def test_stale_incarnation_refused_at_handshake():
    host = tnet.TcpHost()
    link = tnet.start_worker_tcp(host, 0, _echo_worker, {}, incarnation=1)
    try:
        _wait_attached(link)
        with pytest.raises(EOFError):
            zombie = tnet.NetConnection(host.addr, 0, incarnation=0,
                                        max_retries=2, backoff_s=0.01)
            deadline = time.perf_counter() + 5.0
            while time.perf_counter() < deadline:
                zombie.poll(0.05)
                zombie.recv()
        assert host.rejected_stale >= 1
        assert link.send({"kind": "round", "payload": "still mine"})
        assert _wait_recv(link)["echo"] == "still mine"
    finally:
        link.stop()
        host.close()


def test_hostile_frame_drops_connection_not_process():
    import torch

    host = tnet.TcpHost()
    link = tnet.TcpWorkerLink(0)
    host.register(link)
    sock = socket.create_connection(host.addr)
    try:
        hello = pickle.dumps({"kind": tnet.HELLO_KIND, "worker": 0, "incarnation": 0})
        sock.sendall(tnet.encode_frame(hello, 1, 0.0))
        _wait_attached(link)
        # a torch tensor is a forbidden global on the wire, like any gadget
        evil = pickle.dumps({"kind": "result", "values": [("k", torch.ones(2))]})
        sock.sendall(tnet.encode_frame(evil, 2, 0.0))
        deadline = time.perf_counter() + 10.0
        while link.try_recv() is None:
            if link.waitable() is None:
                break
            assert time.perf_counter() < deadline
            time.sleep(0.01)
        assert link.waitable() is None
    finally:
        sock.close()
        host.close()
