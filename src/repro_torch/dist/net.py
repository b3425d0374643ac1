"""TCP socket transport for the master-worker harness.

Port of ``src/repro/dist/net.py``.

The pipe transport (``transport.WorkerLink``) stays the default; this
module is the network backend behind the same link surface, built for
the failure class the paper's Lambda deployment actually exhibits —
*network* trouble, not just slow compute:

* **Framing**: every message is one length-prefixed frame —
  ``MAGIC | payload_len | mid | ts | crc32`` header (:data:`_HEADER`,
  network byte order) followed by the pickled payload.  The CRC covers
  mid + ts + payload, so a corrupted or truncated stream is *detected*,
  never silently mis-parsed.
* **Idempotent resend**: ``mid`` is a per-sender monotonically
  increasing message id.  A sender that hits a socket error retransmits
  the SAME frame after reconnecting; the receiver's :class:`MidFilter`
  drops the duplicate, so at-least-once delivery looks exactly-once to
  the protocol layer.
* **Timestamps**: ``ts`` is the sender's ``perf_counter`` at frame
  encode time (one host, one monotonic base — the same clock contract
  the rest of the telemetry relies on), giving per-message wire
  latency on both directions.
* **Handshake + reconnect**: a connecting worker leads with a
  ``__hello__`` frame carrying its worker id and *incarnation* (its
  respawn count).  :class:`TcpHost` attaches the socket to the
  registered link — unless the incarnation is stale (smaller than the
  link's), in which case the socket is refused: a zombie predecessor
  can never speak for its replacement (split-brain safety; the master
  stays the sole gate authority).  :class:`NetConnection` reconnects
  with bounded exponential backoff and re-runs the hello each time.
* **Fault enactment**: the master-side :class:`TcpWorkerLink` enacts
  :class:`~repro_torch.dist.injection.NetFaultSpec` network faults — one-way
  / two-way partitions (incoming frames buffered like a backed-up TCP
  queue and flushed on heal; two-way also swallows outgoing sends),
  added latency with jitter, probabilistic drop / duplicate / reorder.
  Faults apply *below* the mid filter, so an injected duplicate
  genuinely exercises the dedup path.

``docs/fault_tolerance.md`` ("Network transport & partitions") has the
wire format and the partition-vs-death state machine this backend
feeds.
"""

from __future__ import annotations

import io
import pickle
import socket
import struct
import threading
import time
import zlib

import numpy as np

MAGIC = b"SG"
_HEADER = struct.Struct("!2sIQdI")   # magic, payload_len, mid, ts, crc32
MAX_FRAME = 64 * 1024 * 1024         # sanity bound on payload_len

HELLO_KIND = "__hello__"


class FrameError(ValueError):
    """Corrupted stream: bad magic, oversized length, CRC mismatch, or
    an undecodable / forbidden payload."""


#: builtins a wire payload may name — plain data constructors only.
_SAFE_BUILTINS = frozenset({
    "bool", "int", "float", "complex", "str", "bytes", "bytearray",
    "list", "tuple", "dict", "set", "frozenset", "slice", "range",
})

#: numpy's array/scalar pickle-reconstruction entry points moved from
#: ``numpy.core`` to ``numpy._core`` in numpy 2.x; accept both so a
#: frame encoded by either generation decodes.
_NUMPY_RECON_MODULES = frozenset({
    "numpy.core.multiarray", "numpy._core.multiarray",
})

_NUMPY_SCALARS = frozenset({
    "bool_", "int8", "int16", "int32", "int64", "intp",
    "uint8", "uint16", "uint32", "uint64", "uintp",
    "float16", "float32", "float64", "longdouble",
    "complex64", "complex128", "clongdouble",
    "datetime64", "timedelta64", "str_", "bytes_",
})


class _RestrictedUnpickler(pickle.Unpickler):
    """Unpickler whose ``find_class`` allowlists plain-data builtins and
    numpy array/scalar reconstruction — nothing else.  A TCP frame is a
    trust boundary: a payload naming any other global (``os.system``,
    ``subprocess.*``, arbitrary ``__reduce__`` gadgets) raises
    :class:`FrameError` before any constructor runs."""

    def find_class(self, module: str, name: str):
        if module == "builtins" and name in _SAFE_BUILTINS:
            return super().find_class(module, name)
        if module in _NUMPY_RECON_MODULES and name in (
            "_reconstruct", "scalar",
        ):
            return super().find_class(module, name)
        if module == "numpy" and (
            name in ("ndarray", "dtype") or name in _NUMPY_SCALARS
        ):
            return super().find_class(module, name)
        if module == "numpy.dtypes" and name.endswith("DType"):
            return super().find_class(module, name)
        raise FrameError(
            f"wire payload references forbidden global {module}.{name}"
        )


def safe_loads(payload: bytes):
    """Deserialize one wire payload through the restricted unpickler.

    Every failure mode — forbidden global, truncated pickle stream,
    structurally bogus opcodes — surfaces as :class:`FrameError`, the
    same class the framing layer raises, so callers have exactly one
    "this peer is speaking garbage" path (drop the socket, let the
    reconnect/partition machinery take over)."""
    try:
        return _RestrictedUnpickler(io.BytesIO(payload)).load()
    except FrameError:
        raise
    except (pickle.UnpicklingError, EOFError, AttributeError, ImportError,
            IndexError, KeyError, MemoryError, TypeError, ValueError,
            struct.error) as exc:
        raise FrameError(f"undecodable wire payload: {exc!r}") from exc


def frame_crc(payload: bytes, mid: int, ts: float) -> int:
    return zlib.crc32(payload, zlib.crc32(struct.pack("!Qd", mid, ts)))


def encode_frame(payload: bytes, mid: int, ts: float) -> bytes:
    """One wire frame: header + raw payload bytes."""
    if len(payload) > MAX_FRAME:
        raise FrameError(f"payload {len(payload)} exceeds {MAX_FRAME}")
    crc = frame_crc(payload, mid, ts)
    return _HEADER.pack(MAGIC, len(payload), mid, ts, crc) + payload


class FrameDecoder:
    """Incremental frame parser over an arbitrary byte stream.

    ``feed(data)`` returns every complete ``(payload, mid, ts)`` frame
    the buffer now holds; partial frames wait for more bytes.  A bad
    magic or CRC raises :class:`FrameError` — the stream is
    unrecoverable past that point (framing is lost), so callers drop
    the connection and let the reconnect/resend layer recover.
    """

    def __init__(self):
        self._buf = bytearray()

    @property
    def pending_bytes(self) -> int:
        return len(self._buf)

    def feed(self, data: bytes) -> list[tuple[bytes, int, float]]:
        self._buf.extend(data)
        out = []
        while True:
            if len(self._buf) < _HEADER.size:
                return out
            magic, length, mid, ts, crc = _HEADER.unpack_from(self._buf)
            if magic != MAGIC:
                raise FrameError(f"bad magic {bytes(magic)!r}")
            if length > MAX_FRAME:
                raise FrameError(f"frame length {length} exceeds bound")
            end = _HEADER.size + length
            if len(self._buf) < end:
                return out
            payload = bytes(self._buf[_HEADER.size:end])
            del self._buf[:end]
            if frame_crc(payload, mid, ts) != crc:
                raise FrameError(f"crc mismatch on mid {mid}")
            out.append((payload, mid, ts))


class MidFilter:
    """Duplicate suppression on monotonically increasing message ids.

    ``accept(mid)`` is True exactly once per id.  Ids at or below the
    contiguous low-water mark are rejected outright; a bounded set
    tracks the (reordered) ids above it, so memory stays O(window) even
    on a long run."""

    def __init__(self):
        self._floor = 0          # every mid <= floor already accepted
        self._seen: set[int] = set()

    def accept(self, mid: int) -> bool:
        if mid <= self._floor or mid in self._seen:
            return False
        self._seen.add(mid)
        while self._floor + 1 in self._seen:
            self._floor += 1
            self._seen.discard(self._floor)
        return True


# ---------------------------------------------------------------------------
# worker side: NetConnection (duck-types multiprocessing.Connection)
# ---------------------------------------------------------------------------


class NetConnection:
    """Worker-side endpoint: the subset of ``mp.Connection`` that
    ``worker_main`` uses (``send`` / ``recv`` / ``poll`` / ``close``)
    over one TCP socket, with transparent reconnect.

    * ``send`` pickles into a frame (stamping ``msg["_sent"]`` for the
      wire-telemetry split) and retransmits the SAME frame after a
      reconnect — the host-side mid filter makes that idempotent.
    * ``recv`` / ``poll`` parse frames off the socket, dedup by mid,
      and remember the last frame's master->worker wire lag.
    * Reconnects are bounded exponential backoff; exhaustion raises
      ``EOFError`` (what ``worker_main`` treats as "master gone").
    """

    def __init__(self, addr, worker_id: int, incarnation: int = 0, *,
                 connect_timeout: float = 10.0, max_retries: int = 6,
                 backoff_s: float = 0.05, backoff_max_s: float = 2.0):
        self.addr = tuple(addr)
        self.worker_id = int(worker_id)
        self.incarnation = int(incarnation)
        self.connect_timeout = connect_timeout
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self._sock: socket.socket | None = None
        self._decoder = FrameDecoder()
        self._filter = MidFilter()
        self._inbox: list[dict] = []
        self._mid = 0
        self._closed = False
        self.last_wire_lag: float | None = None
        self._connect()

    # -- wire ------------------------------------------------------------
    def _connect(self) -> None:
        """(Re)establish the socket and lead with the hello frame."""
        last_exc: Exception | None = None
        for attempt in range(self.max_retries + 1):
            if attempt:
                time.sleep(min(self.backoff_s * (2.0 ** (attempt - 1)),
                               self.backoff_max_s))
            try:
                sock = socket.create_connection(
                    self.addr, timeout=self.connect_timeout
                )
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                hello = pickle.dumps({
                    "kind": HELLO_KIND,
                    "worker": self.worker_id,
                    "incarnation": self.incarnation,
                })
                self._mid += 1
                sock.sendall(encode_frame(hello, self._mid,
                                          time.perf_counter()))
                sock.settimeout(None)
                self._sock = sock
                self._decoder = FrameDecoder()
                return
            except OSError as exc:
                last_exc = exc
        self._sock = None
        raise EOFError(f"cannot reach master at {self.addr}: {last_exc}")

    def send(self, msg: dict) -> None:
        if self._closed:
            raise OSError("connection closed")
        msg = dict(msg)
        msg["_sent"] = time.perf_counter()
        self._mid += 1
        frame = encode_frame(pickle.dumps(msg), self._mid,
                             msg["_sent"])
        for attempt in range(2):
            try:
                if self._sock is None:
                    self._connect()
                self._sock.sendall(frame)
                return
            except OSError:
                self._drop_socket()
                if attempt:
                    raise
        raise OSError("send failed after reconnect")

    def _drop_socket(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None

    def _pump(self, timeout: float | None) -> bool:
        """Read whatever the socket has (blocking up to ``timeout``)
        into the inbox; True if the inbox is non-empty afterwards."""
        if self._inbox:
            return True
        if self._sock is None:
            self._connect()
        try:
            self._sock.settimeout(timeout)
            data = self._sock.recv(65536)
        except (TimeoutError, socket.timeout):
            return False
        except OSError:
            self._drop_socket()
            return False
        finally:
            if self._sock is not None:
                try:
                    self._sock.settimeout(None)
                except OSError:
                    pass
        if not data:                     # orderly EOF from the master
            self._drop_socket()
            raise EOFError("master closed the connection")
        try:
            frames = self._decoder.feed(data)
        except FrameError:
            self._drop_socket()          # framing lost: force reconnect
            return False
        now = time.perf_counter()
        for payload, mid, ts in frames:
            if not self._filter.accept(mid):
                continue
            try:
                msg = safe_loads(payload)
            except FrameError:
                self._drop_socket()      # hostile/garbled payload: same
                return False             # path as a framing loss
            self.last_wire_lag = now - ts
            self._inbox.append(msg)
        return bool(self._inbox)

    # -- mp.Connection surface -------------------------------------------
    def poll(self, timeout: float = 0.0):
        if self._closed:
            raise OSError("connection closed")
        if self._inbox:
            return True
        try:
            return self._pump(timeout if timeout > 0 else 0.0001)
        except EOFError:
            return True                  # let recv raise the EOF

    def recv(self) -> dict:
        if self._closed:
            raise OSError("connection closed")
        while not self._inbox:
            self._pump(0.25)
        return self._inbox.pop(0)

    def close(self) -> None:
        self._closed = True
        self._drop_socket()


def tcp_child_main(spec: tuple, target, setup) -> None:
    """Spawn shim: build the worker's :class:`NetConnection` from the
    picklable ``spec`` and hand it to the normal worker target."""
    addr, worker_id, incarnation = spec
    try:
        conn = NetConnection(addr, worker_id, incarnation)
    except EOFError:
        return                           # master was gone before we started
    try:
        target(conn, setup)
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# master side: TcpHost + TcpWorkerLink
# ---------------------------------------------------------------------------


class TcpWorkerLink:
    """Master-side handle on one TCP worker: the ``WorkerLink`` surface
    plus reconnect-awareness and network-fault enactment.

    Unlike the pipe link, losing the socket does NOT mark the link
    broken: the process may be alive behind a partition and the host
    will re-attach its reconnect.  ``peer_alive()`` is what separates
    *partitioned* from *dead* for the supervisor."""

    reconnectable = True

    def __init__(self, worker_id: int, *, incarnation: int = 0,
                 fault=None, seed: int = 0):
        self.worker_id = worker_id
        self.process = None
        self.incarnation = int(incarnation)
        self.broken = False
        self.fault = fault
        self._rng = np.random.default_rng(
            [seed, getattr(fault, "seed", 0) or 0, worker_id, 0x0e7]
        )
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._decoder = FrameDecoder()
        self._filter = MidFilter()
        self._mid = 0
        self._seq = 0
        self._queue: list[tuple[float, int, int, float, dict]] = []
        self._preload: list[tuple[bytes, int, float]] = []
        self._held: list[tuple[int, float, dict]] = []
        self._round = 0
        self._partition_t0: float | None = None
        self._was_partitioned = False

    # -- partition bookkeeping -------------------------------------------
    def set_round(self, t: int) -> None:
        self._round = int(t)

    def _partition_active(self, now: float) -> bool:
        f = self.fault
        if f is None or f.partition_round is None:
            return False
        if self._round < f.partition_round:
            return False
        if self._partition_t0 is None:
            self._partition_t0 = now
            self._was_partitioned = True
        if f.heal_after_s is not None:
            return now - self._partition_t0 < f.heal_after_s
        return self._round < f.partition_round + f.partition_rounds

    # -- socket attach (host accept thread) ------------------------------
    def attach(self, sock: socket.socket, *,
               decoder: FrameDecoder | None = None,
               pending: list[tuple[bytes, int, float]] = ()) -> None:
        """Adopt a freshly-handshaken socket.  The handshake may have
        read past the hello — its decoder (holding any partial frame)
        and already-parsed extra frames carry over so nothing the
        worker pipelined behind the hello is lost."""
        with self._lock:
            old, self._sock = self._sock, sock
            self._decoder = decoder if decoder is not None else FrameDecoder()
            self._preload.extend(pending)
        if old is not None:
            try:
                old.close()
            except OSError:
                pass

    def _detach(self) -> None:
        with self._lock:
            sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    # -- WorkerLink surface ----------------------------------------------
    def alive(self) -> bool:
        return (not self.broken and self.process is not None
                and self.process.is_alive())

    def peer_alive(self) -> bool:
        """The worker *process* is up, whether or not we can reach it —
        the discriminator between a partition and a death."""
        return self.process is not None and self.process.is_alive()

    def waitable(self):
        return self._sock

    def send(self, msg: dict) -> bool:
        if self.broken:
            return False
        now = time.perf_counter()
        f = self.fault
        if self._partition_active(now) and f.partition_mode == "twoway":
            return True                  # swallowed by the partition
        if f is not None and f.drop_p > 0 \
                and self._rng.random() < f.drop_p:
            return True                  # lost on the wire
        msg = dict(msg)
        msg["_sent"] = time.perf_counter()
        self._mid += 1
        frame = encode_frame(pickle.dumps(msg), self._mid, msg["_sent"])
        with self._lock:
            sock = self._sock
        if sock is None:
            return False
        try:
            sock.sendall(frame)
            return True
        except OSError:
            self._detach()               # unreachable, not (yet) dead
            return False

    def _intake(self, msg: dict, mid: int, ts: float) -> None:
        """Fault layer between the wire and delivery (dedup happens at
        delivery, so injected duplicates exercise the mid filter)."""
        now = time.perf_counter()
        f = self.fault
        if self._partition_active(now):
            self._held.append((mid, ts, msg))
            return
        copies = 1
        if f is not None:
            if f.drop_p > 0 and self._rng.random() < f.drop_p:
                return
            if f.dup_p > 0 and self._rng.random() < f.dup_p:
                copies = 2
        for _ in range(copies):
            due = now
            if f is not None:
                if f.latency_s > 0 or f.latency_jitter_s > 0:
                    due += f.latency_s + f.latency_jitter_s * float(
                        self._rng.random()
                    )
                if f.reorder_p > 0 and self._rng.random() < f.reorder_p:
                    due += f.reorder_hold_s
            self._seq += 1
            self._queue.append((due, self._seq, mid, ts, msg))

    def _pump(self) -> None:
        """Drain the socket non-blockingly into the fault queue."""
        with self._lock:
            sock = self._sock
            preload, self._preload = self._preload, []
        for payload, mid, ts in preload:
            try:
                msg = safe_loads(payload)
            except FrameError:
                self._detach()           # poisoned handshake backlog
                return
            self._intake(msg, mid, ts)
        if sock is not None:
            while True:
                try:
                    sock.settimeout(0.0)
                    data = sock.recv(65536)
                except (BlockingIOError, TimeoutError, socket.timeout):
                    break
                except OSError:
                    self._detach()
                    break
                finally:
                    try:
                        sock.settimeout(None)
                    except OSError:
                        pass
                if not data:             # peer closed its end
                    self._detach()
                    break
                try:
                    frames = self._decoder.feed(data)
                    for payload, mid, ts in frames:
                        self._intake(safe_loads(payload), mid, ts)
                except FrameError:
                    self._detach()       # framing/payload lost: await
                    break                # reconnect
        # a healed partition flushes the held frames in order, like a
        # backed-up TCP buffer finally delivering
        if self._held and not self._partition_active(time.perf_counter()):
            held, self._held = self._held, []
            for mid, ts, msg in held:
                self._intake(msg, mid, ts)

    def try_recv(self) -> dict | None:
        if self.broken:
            return None
        self._pump()
        now = time.perf_counter()
        due = [k for k, item in enumerate(self._queue) if item[0] <= now]
        while due:
            k = min(due, key=lambda j: self._queue[j][0])
            _, _, mid, ts, msg = self._queue.pop(k)
            if not self._filter.accept(mid):
                due = [j for j, item in enumerate(self._queue)
                       if item[0] <= now]
                continue
            msg = dict(msg)
            msg["_wire_lag"] = now - ts
            return msg
        return None

    def has_ready(self) -> bool:
        if self._preload:
            return True
        now = time.perf_counter()
        return any(item[0] <= now for item in self._queue)

    def next_due(self) -> float | None:
        if not self._queue:
            return None
        return min(item[0] for item in self._queue)

    def drain(self) -> list[dict]:
        out = []
        while (msg := self.try_recv()) is not None:
            out.append(msg)
        return out

    def stop(self, join_timeout: float = 2.0) -> None:
        try:
            self.send({"kind": "stop"})
            if self.process is not None:
                self.process.join(join_timeout)
                if self.process.is_alive():
                    self.process.terminate()
                    self.process.join(join_timeout)
        except (OSError, ValueError):
            pass
        finally:
            self._detach()

    def kill(self) -> None:
        self.broken = True
        try:
            if self.process is not None and self.process.is_alive():
                self.process.terminate()
                self.process.join(1.0)
        except (OSError, ValueError):
            pass
        finally:
            self._detach()


class TcpHost:
    """The master's listener: accepts worker connections, validates the
    hello handshake, and attaches sockets to their registered links.

    A hello whose incarnation is *older* than the link's is refused and
    the socket closed — a zombie from before a respawn can never
    deliver into the current incarnation's stream."""

    def __init__(self, host: str = "127.0.0.1"):
        self._listener = socket.create_server((host, 0), backlog=64)
        self.addr = self._listener.getsockname()
        self._links: dict[int, TcpWorkerLink] = {}
        self._lock = threading.Lock()
        self._closing = False
        self.rejected_stale = 0
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._thread.start()

    def register(self, link: TcpWorkerLink) -> None:
        with self._lock:
            self._links[link.worker_id] = link

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            try:
                self._handshake(sock)
            except (OSError, FrameError, pickle.UnpicklingError,
                    EOFError, ValueError):
                try:
                    sock.close()
                except OSError:
                    pass

    def _handshake(self, sock: socket.socket) -> None:
        sock.settimeout(5.0)
        decoder = FrameDecoder()
        frames: list = []
        while not frames:
            data = sock.recv(65536)
            if not data:
                raise EOFError("peer closed during handshake")
            frames = decoder.feed(data)
        payload, _mid, _ts = frames[0]
        hello = safe_loads(payload)
        if hello.get("kind") != HELLO_KIND:
            raise ValueError(f"expected hello, got {hello.get('kind')!r}")
        wid = int(hello["worker"])
        inc = int(hello.get("incarnation", 0))
        with self._lock:
            link = self._links.get(wid)
        if link is None or inc < link.incarnation or link.broken:
            self.rejected_stale += 1
            sock.close()                 # stale incarnation: refused
            return
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(None)
        link.attach(sock, decoder=decoder, pending=frames[1:])

    def close(self) -> None:
        self._closing = True
        try:
            self._listener.close()
        except OSError:
            pass
        self._thread.join(2.0)


def start_worker_tcp(
    host: TcpHost,
    worker_id: int,
    target,
    setup,
    *,
    incarnation: int = 0,
    fault=None,
    seed: int = 0,
    start_method: str = "spawn",
) -> TcpWorkerLink:
    """Spawn one worker that dials back into ``host`` over TCP; the
    returned link is already registered for the handshake."""
    import multiprocessing as mp

    link = TcpWorkerLink(worker_id, incarnation=incarnation,
                         fault=fault, seed=seed)
    host.register(link)
    ctx = mp.get_context(start_method)
    spec = (tuple(host.addr), worker_id, incarnation)
    proc = ctx.Process(target=tcp_child_main, args=(spec, target, setup),
                       daemon=True)
    proc.start()
    link.process = proc
    return link
