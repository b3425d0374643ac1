"""Worker process: real per-chunk partial gradients + enacted faults.

Port of ``src/repro/dist/worker.py``.

``worker_main`` is the spawn target.  Each round message carries
executor-style mini-task items ``{"key", "chunks", "coeffs"}``; the
worker computes every referenced chunk gradient for real and returns
the coefficient-weighted combinations — exactly the quantities the
master's ``JobDecode`` weights reconstruct the full gradient from, for
all registered schemes (GC/SR-SGC ``ell`` rows, M-SGC ``d1``/``d2``
parts, clustered per-cluster codes, uncoded chunks).

Two compute modes, shared with the master through
:class:`TaskComputer` (the master instantiates the same class to form
the full-gradient truth its decode certificate checks against):

* ``linear`` (default) — closed-form least-squares chunk gradients
  ``g_c = X_c^T (X_c theta - y_c)`` on a deterministic per-job dataset;
  numpy on the host, as in the JAX package (the protocol's closed-form
  oracle): exact decode, and a linear-mode child never imports torch.
* ``grad`` — the coded trainer's per-chunk gradient path: autograd of
  ``train.coded.chunk_loss_sum`` on deterministic ``data.token_batch``
  chunks of a real transformer LM, on ``device`` (the card unless the
  caller asks for the CPU), raveled in the JAX package's
  ``ravel_pytree`` order.  An item's chunk gradients are stacked into
  (k, D) on the device and encoded with the item's coefficients in one
  ``coded_combine`` (the kernel on a CUDA device, its plain version on
  the CPU); the result crosses to the host once, as a float32 numpy
  array, which is what the wire carries.

Fault enactment (``injection.FaultSpec``): the per-round delay from the
master's trace is burned before reporting; ``drop_rounds`` suppresses
first-attempt sends (the master's resend recovers the cached result);
``kill_after`` exits the process for good.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from .injection import FaultSpec, enact_delay


def linear_job_data(seed: int, job: int, num_rows: int, dim: int):
    """Deterministic per-job least-squares problem (X, y, theta)."""
    rng = np.random.default_rng([seed, 7919, job])
    X = rng.standard_normal((num_rows, dim))
    y = rng.standard_normal(num_rows)
    theta = rng.standard_normal(dim)
    return X, y, theta


def reference_leaves(tree) -> list[list]:
    """The leaves of a parameter tree in the order ``jax.flatten_util.
    ravel_pytree`` lays out the JAX package's tree: dict keys sorted, and
    the port's list of per-layer dicts taken as the JAX package's stacked
    (L, ...) leaves, so each entry is one JAX leaf as the tensors that make
    it up (one per layer, layer-major)."""
    if isinstance(tree, dict):
        return [g for k in sorted(tree) for g in reference_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        if tree and all(isinstance(t, dict) for t in tree):
            per_layer = [reference_leaves(t) for t in tree]
            return [[part for group in groups for part in group]
                    for groups in zip(*per_layer)]
        return [g for t in tree for g in reference_leaves(t)]
    return [[tree]]


def ravel_into(out, tree) -> None:
    """Copy a tree's leaves into the flat vector ``out`` in the JAX
    package's ravel order (:func:`reference_leaves`)."""
    off = 0
    for group in reference_leaves(tree):
        for t in group:
            n = t.numel()
            out[off:off + n].copy_(t.reshape(-1))
            off += n
    if off != out.numel():
        raise ValueError(f"tree holds {off} values, the vector {out.numel()}")


class TaskComputer:
    """Chunk-gradient oracle shared by workers (per-task values) and
    the master (full-gradient decode certificate)."""

    def __init__(self, seed: int, compute: str, dim: int, num_rows: int,
                 bounds, model_cfg=None, batch_size: int = 0,
                 seq_len: int = 0, device="cuda"):
        self.seed = seed
        self.compute = compute
        self.dim = dim
        self.num_rows = num_rows
        self.bounds = [tuple(b) for b in bounds]
        self._jobs: dict[int, tuple] = {}
        if compute == "grad":
            self._init_grad(model_cfg, batch_size, seq_len, device)
        elif compute != "linear":
            raise ValueError(f"unknown compute mode {compute!r}")

    # -- linear mode -----------------------------------------------------
    def _linear_data(self, job: int):
        if job not in self._jobs:
            if len(self._jobs) > 64:
                self._jobs.clear()
            self._jobs[job] = linear_job_data(
                self.seed, job, self.num_rows, self.dim
            )
        return self._jobs[job]

    # -- grad mode (train/coded.py per-chunk gradient path) --------------
    def _init_grad(self, model_cfg, batch_size: int, seq_len: int, device):
        from repro_torch.devices import resolve_device

        if model_cfg is None or batch_size <= 0:
            raise ValueError("grad mode needs model_cfg and batch_size")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            from repro_torch.kernels import _build

            _build.library()    # a kernel that does not build fails here
        self.cfg = model_cfg
        self.batch_size = batch_size
        self.seq_len = seq_len

    def _grad_data(self, job: int):
        import torch

        from repro_torch.data import token_batch
        from repro_torch.train.coded import init_train_state

        if job not in self._jobs:
            if len(self._jobs) > 16:
                self._jobs.clear()
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.seed * 100003 + job)
            params, _ = init_train_state(self.cfg, gen)
            batch = token_batch(
                self.seed, job, self.batch_size, self.seq_len,
                self.cfg.vocab_size, device=self.device,
            )
            self._jobs[job] = (params, batch)
        return self._jobs[job]

    def _grad_into(self, out, job: int, lo: int, hi: int) -> None:
        """The gradient of ``chunk_loss_sum`` over rows [lo, hi) of the
        job's batch, raveled into ``out``."""
        from repro_torch.train.coded import chunk_loss_sum, value_and_grad

        params, batch = self._grad_data(job)
        cb = {k: v[lo:hi] for k, v in batch.items()}
        _, grads = value_and_grad(
            lambda p: chunk_loss_sum(p, self.cfg, cb), params
        )
        ravel_into(out, grads)

    def _flat(self, rows: int, job: int):
        import torch

        params, _ = self._grad_data(job)
        size = sum(t.numel() for g in reference_leaves(params) for t in g)
        return torch.empty((rows, size), dtype=torch.float32,
                           device=self.device)

    # -- shared surface --------------------------------------------------
    def set_bounds(self, bounds) -> None:
        """Adopt a new chunk partition (master ``reconfig`` after the
        fleet shrank): per-job data is partition-independent, so only
        the slice table changes."""
        self.bounds = [tuple(b) for b in bounds]

    def chunk_grad(self, job: int, chunk: int) -> np.ndarray:
        lo, hi = self.bounds[chunk]
        if self.compute == "linear":
            X, y, theta = self._linear_data(job)
            Xc = X[lo:hi]
            return Xc.T @ (Xc @ theta - y[lo:hi])
        out = self._flat(1, job)
        self._grad_into(out[0], job, lo, hi)
        return out[0].cpu().numpy()

    def value(self, item: dict) -> np.ndarray:
        """Coefficient-weighted combination of the item's chunk grads."""
        chunks = item["chunks"]
        coeffs = item["coeffs"]
        if self.compute == "linear":
            out = coeffs[0] * self.chunk_grad(item["job"], chunks[0])
            for c, w in zip(chunks[1:], coeffs[1:]):
                out = out + w * self.chunk_grad(item["job"], c)
            return out
        from repro_torch.kernels.gc_coding import coded_combine

        parts = self._flat(len(chunks), item["job"])
        for r, c in enumerate(chunks):
            self._grad_into(parts[r], item["job"], *self.bounds[c])
        return coded_combine(parts, coeffs).cpu().numpy()

    def warmup(self) -> None:
        """Run the grad-mode path once for every distinct chunk shape
        (workers call this before reporting ready, so start-up cost never
        counts against round timeouts or round measurement)."""
        if self.compute != "grad":
            return
        seen = set()
        for c, (lo, hi) in enumerate(self.bounds):
            if hi - lo not in seen:
                seen.add(hi - lo)
                self.chunk_grad(1, c)

    def full_grad(self, job: int) -> np.ndarray:
        """Full-batch gradient (the master's decode truth)."""
        if self.compute == "linear":
            X, y, theta = self._linear_data(job)
            return X.T @ (X @ theta - y)
        out = self._flat(1, job)
        self._grad_into(out[0], job, 0, self.batch_size)
        return out[0].cpu().numpy()


@dataclass(frozen=True)
class WorkerSetup:
    """Everything a spawned worker needs (must stay picklable)."""

    worker_id: int
    seed: int
    compute: str = "linear"
    dim: int = 8
    num_rows: int = 64
    bounds: tuple = ()
    fault: FaultSpec = field(default_factory=FaultSpec)
    model_cfg: object = None
    batch_size: int = 0
    seq_len: int = 0
    device: str = "cuda"

    def computer(self) -> TaskComputer:
        return TaskComputer(
            self.seed, self.compute, self.dim, self.num_rows, self.bounds,
            model_cfg=self.model_cfg, batch_size=self.batch_size,
            seq_len=self.seq_len, device=self.device,
        )


def _pong(conn, worker_id: int, msg: dict) -> bool:
    """Answer a liveness ping (piggybacked on the round protocol);
    returns False when the pipe is gone."""
    try:
        conn.send({"kind": "pong", "worker": worker_id,
                   "seq": msg.get("seq")})
        return True
    except (BrokenPipeError, EOFError, OSError):
        return False


def _enact_cancellable(conn, worker_id: int, t: int, seconds: float,
                       mode: str):
    """Burn the injected delay, but abandon it if the master has moved
    on to a later round — the protocol's task cancellation: a straggler
    whose result was not admitted stops wasting time on it.  Returns the
    interrupting message (later round / stop) or ``None`` when the full
    delay elapsed.  Same-round resends arriving mid-delay are absorbed
    (the single reply after the delay answers them), and liveness pings
    are answered inline so a slow worker is never mistaken for a dead
    one."""
    deadline = time.perf_counter() + seconds
    while True:
        remaining = deadline - time.perf_counter()
        if remaining <= 0:
            return None
        enact_delay(min(remaining, 0.005), mode)
        try:
            if conn.poll(0):
                nxt = conn.recv()
                if nxt.get("kind") == "ping":
                    if not _pong(conn, worker_id, nxt):
                        return {"kind": "stop"}
                    continue
                if nxt.get("kind") == "round" and int(nxt["t"]) <= t:
                    continue
                return nxt
        except (EOFError, OSError):
            return {"kind": "stop"}


def worker_main(conn, setup: WorkerSetup) -> None:
    """Spawn target: serve round messages until stopped or killed."""
    fault = setup.fault
    computer = setup.computer()
    computer.warmup()
    if fault.ready_delay > 0:
        time.sleep(fault.ready_delay)   # slow (re)join
    # readiness handshake: the master must not start round timeouts
    # while children are still paying interpreter/import/CUDA start-up
    # cost
    try:
        conn.send({"kind": "ready", "worker": setup.worker_id})
    except (BrokenPipeError, OSError):
        return
    cache: dict[int, tuple] = {}      # t -> (values, compute_s, delay_s)
    pending = None                    # message that cancelled a delay
    while True:
        if pending is not None:
            msg, pending = pending, None
        else:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                return
        kind = msg.get("kind")
        if kind == "stop":
            return
        if kind == "ping":
            if not _pong(conn, setup.worker_id, msg):
                return
            continue
        if kind == "reconfig":
            # the fleet shrank: adopt the survivors' chunk partition and
            # forget results keyed on the old one
            computer.set_bounds(msg["bounds"])
            computer.warmup()
            cache.clear()
            continue
        if kind != "round":
            continue
        t, attempt = int(msg["t"]), int(msg["attempt"])
        t_recv = time.perf_counter()
        # master->worker wire time: the transport stamps "_sent" on the
        # master clock at send (same perf_counter base on one host)
        wire_s = (t_recv - float(msg["_sent"])
                  if msg.get("_sent") is not None else None)
        if t in cache:
            # resend path: the result was computed on the first attempt
            # and only the message was lost — answer from the cache
            values, compute_s, delay_s = cache[t]
        else:
            t0 = time.perf_counter()
            values = [(it["key"], computer.value(it))
                      for it in msg["items"]]
            compute_s = time.perf_counter() - t0
            delay_s = float(msg["delay_s"])
            pending = _enact_cancellable(
                conn, setup.worker_id, t, delay_s, fault.delay_mode
            )
            if pending is not None:
                if pending.get("kind") == "stop":
                    return
                continue              # round cancelled by a newer one
            cache[t] = (values, compute_s, delay_s)
            for old in [k for k in cache if k < t - 4]:
                del cache[old]
        if not fault.drops(t, attempt):
            reply = {
                "kind": "result",
                "t": t,
                "attempt": attempt,
                "worker": setup.worker_id,
                "values": values,
                "telemetry": {
                    "recv": t_recv,
                    "delay_s": delay_s,
                    "compute_s": compute_s,
                    "wire_s": wire_s,
                    "sent": time.perf_counter(),
                },
            }
            try:
                conn.send(reply)
            except (BrokenPipeError, OSError):
                return
        if fault.dies_after(t):
            try:
                conn.close()
            finally:
                return
