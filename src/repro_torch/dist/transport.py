"""Process/pipe transport for the master-worker harness.

Port of ``src/repro/dist/transport.py``.

One duplex :func:`multiprocessing.Pipe` per worker, one spawned process
per worker (``spawn`` keeps children free of inherited CUDA state),
and a thin :class:`WorkerLink` the master drives non-blockingly — the
``Isend``/``Irecv`` request-array idiom of the MPI coded-computation
harnesses, restated on ``multiprocessing.connection``.

Messages are plain dicts with a ``"kind"`` key:

* master -> worker: ``{"kind": "round", "t", "attempt", "items",
  "delay_s"}`` (work for one round; ``items`` are executor-style
  mini-task dicts) and ``{"kind": "stop"}``.
* worker -> master: ``{"kind": "result", "t", "attempt", "worker",
  "values": [(key, vec), ...], "telemetry": {...}}``.

Every send/recv is guarded: a broken pipe marks the link dead instead
of raising, so the master's timeout/retry layer owns all failure
policy.

The master reads a message in reads of at most ``_READ_CHUNK`` bytes into
one buffer (:func:`_recv`), the same bytes and the same unpickling as
``Connection.recv``: that asks ``os.read`` for the whole remainder of the
message on every call, which allocates that much each time, and on a host
where a large allocation costs in proportion to its size a message costs
the square of its size (the card's host: PERF.md, ``[harness]``).
"""

from __future__ import annotations

import multiprocessing as mp
import multiprocessing.connection  # noqa: F401  (mp.connection.wait)
import multiprocessing.reduction
import os
import struct
import time
from typing import Any, Callable

#: bytes asked of the OS per read while a message is received
_READ_CHUNK = 1 << 20


def _read_into(fd: int, view: memoryview) -> None:
    got = 0
    while got < len(view):
        n = os.readv(fd, [view[got:got + _READ_CHUNK]])
        if n == 0:
            raise EOFError("peer closed the pipe mid-message")
        got += n


def _recv(conn):
    """``conn.recv()`` (module docstring): the length header
    ``Connection.send`` writes, then the pickled payload, read in bounded
    chunks into one buffer."""
    fd = conn.fileno()
    head = bytearray(4)
    _read_into(fd, memoryview(head))
    size, = struct.unpack("!i", head)
    if size == -1:                      # a message of 2 GiB or more
        head = bytearray(8)
        _read_into(fd, memoryview(head))
        size, = struct.unpack("!Q", head)
    buf = bytearray(size)
    _read_into(fd, memoryview(buf))
    # the pipe's own deserialization, as Connection.recv does it: a pipe
    # joins the master to a child it spawned (the TCP wire goes through
    # net.safe_loads)
    return mp.reduction.ForkingPickler.loads(buf)


class WorkerLink:
    """Master-side handle on one worker process.

    The link *surface* (``alive`` / ``send`` / ``try_recv`` / ``drain``
    / ``stop`` / ``kill`` plus the ``reconnectable`` / ``peer_alive`` /
    ``waitable`` probes below) is the transport contract: the TCP
    backend (``repro_torch.dist.net.TcpWorkerLink``) implements the same
    surface, and the supervisor/master never look behind it."""

    #: a pipe dies with its process: losing it is losing the worker.
    #: The TCP backend overrides this — there, an unreachable peer may
    #: merely be partitioned.
    reconnectable = False

    def __init__(self, worker_id: int, process, conn):
        self.worker_id = worker_id
        self.process = process
        self.conn = conn
        self.broken = False

    def alive(self) -> bool:
        return not self.broken and self.process.is_alive()

    def peer_alive(self) -> bool:
        """Is the worker *process* up (reachable or not)?"""
        return self.process.is_alive()

    def waitable(self):
        """The selectable object ``wait_any`` blocks on (None: none)."""
        return self.conn

    def has_ready(self) -> bool:
        """Deliverable message already queued (deferred-delivery
        backends); the pipe backend lets ``connection.wait`` decide."""
        return False

    def next_due(self) -> float | None:
        """Earliest future delivery deadline, if any (caps the
        ``wait_any`` sleep for latency-injecting backends)."""
        return None

    def send(self, msg: dict) -> bool:
        """Best-effort send; returns False (and marks the link broken)
        when the peer is gone.  Stamps ``msg["_sent"]`` (master clock)
        so the worker can split wire time from compute time."""
        if self.broken:
            return False
        try:
            msg["_sent"] = time.perf_counter()
            self.conn.send(msg)
            return True
        except (BrokenPipeError, EOFError, OSError, ValueError):
            self.broken = True
            return False

    def try_recv(self) -> dict | None:
        """Non-blocking receive: one message if ready, else None."""
        if self.broken:
            return None
        try:
            if self.conn.poll(0):
                return _recv(self.conn)
        except (EOFError, BrokenPipeError, OSError):
            self.broken = True
        return None

    def drain(self) -> list[dict]:
        """Pop every queued message (stale results from prior rounds)."""
        out = []
        while True:
            msg = self.try_recv()
            if msg is None:
                return out
            out.append(msg)

    def stop(self, join_timeout: float = 2.0) -> None:
        """Graceful shutdown that NEVER raises out of master cleanup: a
        child that died mid-send leaves the pipe in an EOF/broken state,
        and every step here tolerates that race."""
        try:
            self.send({"kind": "stop"})
            self.process.join(join_timeout)
            if self.process.is_alive():
                self.process.terminate()
                self.process.join(join_timeout)
        except (EOFError, BrokenPipeError, OSError, ValueError):
            pass
        finally:
            try:
                self.conn.close()
            except (EOFError, BrokenPipeError, OSError):
                pass

    def kill(self) -> None:
        """Immediate teardown (no stop message): used by the supervisor
        when retiring a wedged or superseded worker process."""
        self.broken = True
        try:
            if self.process.is_alive():
                self.process.terminate()
                self.process.join(1.0)
        except (OSError, ValueError):
            pass
        finally:
            try:
                self.conn.close()
            except (EOFError, BrokenPipeError, OSError):
                pass


def start_worker(
    worker_id: int,
    target: Callable,
    setup: Any,
    *,
    start_method: str = "spawn",
) -> WorkerLink:
    """Spawn ONE worker process running ``target(conn, setup)`` — the
    primitive both the initial fleet and supervisor respawns use."""
    ctx = mp.get_context(start_method)
    parent_conn, child_conn = ctx.Pipe(duplex=True)
    proc = ctx.Process(target=target, args=(child_conn, setup), daemon=True)
    proc.start()
    child_conn.close()
    return WorkerLink(worker_id, proc, parent_conn)


def start_workers(
    num_workers: int,
    target: Callable,
    setup_for: Callable[[int], Any],
    *,
    start_method: str = "spawn",
) -> list[WorkerLink]:
    """Spawn ``num_workers`` processes running ``target(conn, setup)``
    and return their links.  ``setup_for(worker_id)`` must be picklable
    (``spawn`` re-imports the target module in a clean interpreter, so
    children never inherit the master's CUDA runtime state)."""
    return [
        start_worker(wid, target, setup_for(wid), start_method=start_method)
        for wid in range(num_workers)
    ]


def stop_workers(links: list[WorkerLink]) -> None:
    for link in links:
        link.stop()


def wait_any(links: list[WorkerLink], timeout: float) -> None:
    """Block until some link has data (or ``timeout`` elapses) without
    spinning: a poor man's ``MPI.Waitany`` on connection objects.

    Transport-agnostic via the link probes: returns immediately when a
    deferred-delivery backend already holds a due message, waits on
    each link's ``waitable()`` (pipe connection or socket — both are
    selectable), and never sleeps past the earliest ``next_due()``
    deadline a latency-injecting backend advertises."""
    now = time.perf_counter()
    deadline = now + timeout
    waitables = []
    for lk in links:
        if lk.broken:
            continue
        if lk.has_ready():
            return
        w = lk.waitable()
        if w is not None:
            waitables.append(w)
        nd = lk.next_due()
        if nd is not None:
            deadline = min(deadline, nd)
    timeout = max(0.0, deadline - now)
    if not waitables:
        time.sleep(timeout)
        return
    try:
        mp.connection.wait(waitables, timeout)
    except OSError:
        time.sleep(min(timeout, 0.005))
