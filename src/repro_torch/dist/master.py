"""Master loop: real coded rounds over a supervised, elastic fleet.

Port of ``src/repro/dist/master.py``.  ``HarnessConfig`` has one field the
JAX package's lacks, ``device``: where grad-mode workers and the master's
full-batch truth run (the card unless the caller asks for the CPU).  A
grad-mode run on a CUDA device with no card raises before any worker is
spawned, and on the card the kernels are built before the workers start, so
no child runs ``nvcc``.

``run_harness`` enacts a straggler trace end-to-end: each round it
ships every worker its mini-task items (chunk ids + encode-matrix
coefficients from the scheme's ``assign``/``code`` surface — the same
matrices ``executor.run_protocol`` certifies) together with the
worker's planned delay, then applies the paper's master protocol on
REAL wall clock:

* mu-rule: the planned per-round times ``delays[t-1] + (L - 1/n) *
  alpha`` give the candidate stragglers ``times > (1 + mu) * kappa`` —
  expression-for-expression the ``simulate_fast`` / trainer loop, so
  the recording replays bit-identically through the simulator;
* Remark-2.3 selective wait-out via the stateful ``ConformanceGate``:
  waited-out workers are genuinely waited for (their real results
  arrive and enter the decode), non-admitted stragglers' work is
  cancelled (the worker abandons the round when the next one arrives);
* decode via ``scheme.collect`` — GC/SR-SGC beta vectors, M-SGC group
  weights, ``ClusterGradientCode.decode_vector`` for the clustered
  baselines — numerically checked against the job's full-batch
  gradient when ``check_decode`` is on.

Robustness (see ``docs/fault_tolerance.md`` for the full state
machine):

* per-worker round timeouts with bounded resends (lost messages
  recover from the worker's result cache) and piggybacked liveness
  heartbeats;
* worker death hands off to the :class:`Supervisor`: with a respawn
  budget the replacement process re-runs warmup/readiness and rejoins
  mid-sequence (the open round replayed from the assignment ledger);
  without one the worker degrades to an always-straggler row for as
  long as the gate admits it;
* when deaths outlast the respawn budget and the gate would have to
  wait a lost worker out, ``degrade="shrink"`` re-selects the scheme
  online — a fresh encode matrix is solved on the survivors
  (``GradientCode``/``ClusterGradientCode`` via ``make_scheme``), the
  data re-partitions over the shrunken fleet, and the un-decoded jobs
  re-run, with the decode certificate still checked against the
  full-batch gradient (which is partition-independent).  With
  ``degrade="off"`` the run aborts gracefully as before;
* every ``checkpoint_every`` rounds the full round-loop state
  (admitted-pattern history, in-flight results, decode ledger, RNG
  state, telemetry) is serialized through ``repro.checkpoint.io`` —
  a killed master resumes mid-sequence via ``resume_from`` and the
  resumed run's recorded ``TraceModel`` still replays bit-identically
  through ``simulate_fast`` (gate and scheme state are reconstructed
  by replaying the committed history, of which they are a pure
  function).

The measured round duration honors the protocol's information
constraints: the master cannot proceed before the mu-rule deadline in
any round with candidates (it could not *know* who straggles earlier),
and otherwise proceeds when the last needed result lands.
"""

from __future__ import annotations

import copy
import json
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.executor import decode_from_results
from repro_torch.core.schemes import (
    MSGCScheme,
    Scheme,
    make_scheme,
    normalize_scheme_name,
)
from repro_torch.core.straggler import ConformanceGate
from repro_torch.data.synthetic import chunk_boundaries

from .injection import FaultSpec
from .supervisor import RespawnPolicy, Supervisor
from .telemetry import RunLedger
from .transport import wait_any
from .worker import TaskComputer, WorkerSetup, worker_main


class HarnessError(RuntimeError):
    """Unrecoverable protocol failure (e.g. the gate requires a result
    from a permanently lost worker and degradation is off)."""


class _DegradeSignal(Exception):
    """Internal: the current round cannot complete on the current fleet
    — shrink onto the survivors and re-plan."""

    def __init__(self, bad: list[int]):
        super().__init__(f"lost workers {bad}")
        self.bad = bad


@dataclass
class HarnessConfig:
    """Knobs for one harness run (see module docstring)."""

    mu: float = 1.0
    alpha: object = 8.0                 # scalar or per-worker (n,)
    time_scale: float = 0.05            # planned seconds -> wall seconds
    delay_mode: str = "sleep"           # "sleep" | "spin"
    round_timeout: float | None = None  # None: auto from planned times
    max_retries: int = 1
    compute: str = "linear"             # "linear" | "grad"
    dim: int = 8
    num_rows: int | None = None
    check_decode: bool = True
    decode_atol: float = 1e-6
    seed: int = 0
    faults: dict = field(default_factory=dict)   # worker -> FaultSpec
    start_method: str = "spawn"
    # -- transport (repro_torch.dist.net; docs/fault_tolerance.md) --------
    transport: str = "pipe"             # "pipe" | "tcp"
    net_faults: dict = field(default_factory=dict)  # wid -> NetFaultSpec
    partition_timeout_s: float = 10.0   # partition -> death escalation
    model_cfg: object = None            # grad mode only
    batch_size: int = 0
    seq_len: int = 8
    device: str = "cuda"                # grad mode only: workers' and truth's
    # -- supervision / elasticity (docs/fault_tolerance.md) --------------
    respawn_max_attempts: int = 0       # 0: death is final
    respawn_backoff_s: float = 0.25
    respawn_backoff_max_s: float = 4.0
    respawn_jitter: float = 0.25
    respawn_ready_timeout_s: float = 60.0
    heartbeat_s: float = 0.5
    respawn_faults: dict = field(default_factory=dict)  # wid -> FaultSpec
    degrade: str = "off"                # "off" | "shrink"
    min_workers: int = 2
    round_hard_timeout: float | None = None  # deadlock guard (None: auto)
    # -- checkpoint/resume ------------------------------------------------
    checkpoint_path: str | None = None
    checkpoint_every: int = 0           # rounds between checkpoints; 0 off
    stop_after_round: int | None = None  # simulated master kill

    def policy(self) -> RespawnPolicy:
        return RespawnPolicy(
            max_attempts=self.respawn_max_attempts,
            backoff_s=self.respawn_backoff_s,
            backoff_max_s=self.respawn_backoff_max_s,
            jitter=self.respawn_jitter,
            ready_timeout_s=self.respawn_ready_timeout_s,
            heartbeat_s=self.heartbeat_s,
            partition_timeout_s=self.partition_timeout_s,
        )


@dataclass
class HarnessResult:
    scheme: str
    n: int
    J: int
    time_scale: float
    measured_makespan: float
    analytic_makespan: float
    round_times: np.ndarray             # measured seconds per round
    analytic_round_times: np.ndarray    # planned-model seconds (scaled)
    ledger: RunLedger
    trace_model: object                 # TraceModel recording (v2 when elastic)
    decoded_jobs: dict                  # job -> global round decoded
    job_done_time: dict                 # job -> measured elapsed seconds
    decode_max_err: float
    deaths: list                        # workers that EVER died
    retries: int
    waitouts: int
    aborted: bool = False
    abort_reason: str | None = None
    respawns: int = 0                   # replacement processes spawned
    rejoins: int = 0                    # replacements that reached ready
    partitions: int = 0                 # partition detections (TCP)
    heals: int = 0                      # partitions healed without respawn
    degraded: int = 0                   # shrink re-selections performed
    stopped: bool = False               # stop_after_round fired
    checkpoint_path: str | None = None  # latest checkpoint written
    events: list = field(default_factory=list)   # supervision log

    @property
    def agreement(self) -> float:
        """Measured / analytic makespan (1.0 = perfect agreement)."""
        if self.analytic_makespan <= 0:
            return float("nan")
        return self.measured_makespan / self.analytic_makespan


# ---------------------------------------------------------------------------
# work-item construction (MiniTask -> executor-keyed chunk combination)
# ---------------------------------------------------------------------------


def _item_for(sch: Scheme, mt, job_map: list[int]) -> dict | None:
    """Executor-keyed work item; scheme-local job ids translate through
    ``job_map`` to the original (worker-visible) job ids."""
    if mt.trivial:
        return None
    job = int(job_map[mt.job - 1])
    if mt.kind == "ell":
        row = sch.code.encode_matrix[mt.worker]
        sup = np.flatnonzero(row)
        return {
            "key": ("ell", job, mt.worker),
            "job": job,
            "chunks": [int(c) for c in sup],
            "coeffs": [float(x) for x in row[sup]],
        }
    if mt.kind in ("d1", "all"):
        return {
            "key": ("d1", job, mt.chunk),
            "job": job,
            "chunks": [int(mt.chunk)],
            "coeffs": [1.0],
        }
    if mt.kind == "d2":
        m = mt.chunk
        base = (sch.W - 1) * sch.n + m * sch.n
        row = sch.code.encode_matrix[mt.worker]
        loc = np.flatnonzero(row)
        return {
            "key": ("d2", job, m, mt.worker),
            "job": job,
            "chunks": [int(base + c) for c in loc],
            "coeffs": [float(x) for x in row[loc]],
        }
    raise ValueError(f"unknown mini-task kind {mt.kind!r}")


def _chunk_fractions(sch: Scheme) -> list[float]:
    if isinstance(sch, MSGCScheme):
        return [sch.chunk_fraction(c) for c in range(sch.num_chunks)]
    return [1.0 / sch.n] * sch.n


def _decide(gate: ConformanceGate, cand: np.ndarray,
            cost: np.ndarray) -> tuple[np.ndarray, list[int]]:
    """Provisional Remark-2.3 decision on a gate copy (committed for
    real only once the round's deaths are settled)."""
    if not cand.any():
        return cand.copy(), []
    return copy.deepcopy(gate).admit_partial(cand.copy(), cost)


def _analytic_duration(times: np.ndarray, cutoff: float, tmax: float,
                       cand: np.ndarray, eff: np.ndarray,
                       waited: list[int]) -> float:
    """The simulator's round-duration expression on planned times."""
    if not cand.any():
        return float(min(cutoff, tmax))
    if waited:
        base = float(min(cutoff, tmax)) if eff.any() else cutoff
        return float(max(times[waited].max(), base))
    return float(min(cutoff, tmax))


def degrade_params(name: str, params: dict | None,
                   n_new: int) -> tuple[str, dict]:
    """Re-select scheme parameters for a fleet shrunk to ``n_new``
    survivors: keep the scheme family when its constraints still hold
    at the new size, shrink the straggler budget to fit, and fall back
    to plain GC when a clustered layout no longer divides the fleet.
    The returned pair feeds ``make_scheme``, which re-solves the encode
    matrix (``GradientCode``/``ClusterGradientCode``) on the survivors.
    """
    name = normalize_scheme_name(name)
    p = dict(params or {})
    if n_new < 2:
        raise HarnessError(f"cannot degrade below 2 workers ({n_new})")
    if name == "gc":
        p["s"] = min(int(p.get("s", 1)), n_new - 1)
    elif name in ("sr-sgc", "m-sgc"):
        if "lam" in p:
            p["lam"] = min(int(p["lam"]), n_new)
    elif name in ("dc-gc", "sb-gc"):
        C = int(p.get("C", 4))
        s = int(p.get("s", 1))
        if n_new % C != 0 or n_new // C <= s:
            return "gc", {"s": min(s, n_new - 1)}
    return name, p


# ---------------------------------------------------------------------------
# epochs: one scheme instance over one fleet composition
# ---------------------------------------------------------------------------


@dataclass
class _Epoch:
    """One fleet composition: a scheme + gate over ``survivors``
    (physical worker ids), serving ``job_map`` (scheme-local job j ->
    original job id).  A degradation starts a new epoch."""

    name: str
    params: dict
    sch: Scheme
    gate: ConformanceGate
    survivors: np.ndarray               # (n_eff,) physical ids
    job_map: list[int]
    planned: np.ndarray                 # (rounds, n_eff) planned times
    start_round: int                    # global rounds before this epoch
    bounds: tuple
    truth: TaskComputer | None

    @property
    def n_eff(self) -> int:
        return len(self.survivors)

    @property
    def rounds(self) -> int:
        return len(self.job_map) + self.sch.T


class _MasterLoop:
    """One harness run: epochs of supervised rounds + checkpointing."""

    CKPT_VERSION = 1

    def __init__(self, scheme_name: str, n: int, J: int,
                 delays: np.ndarray, params: dict | None,
                 cfg: HarnessConfig):
        self.scheme_name = normalize_scheme_name(scheme_name)
        self.n, self.J = n, J
        self.params = dict(params or {})
        self.cfg = cfg
        if cfg.compute == "grad":
            from repro_torch.devices import resolve_device

            # no card for a CUDA device raises here, before any spawn
            if resolve_device(cfg.device).type == "cuda":
                from repro_torch.kernels import _build

                _build.library()    # built once here, not by n children
        sch0 = make_scheme(scheme_name, n, J, **self.params)
        rounds0 = J + sch0.T
        self.delays = np.asarray(delays, dtype=np.float64)
        if self.delays.shape[0] < rounds0 or self.delays.shape[1] != n:
            raise ValueError(
                f"need delays (>={rounds0}, {n}), got {self.delays.shape}"
            )
        num_chunks = sch0.num_chunks if isinstance(sch0, MSGCScheme) else n
        self.num_rows = cfg.num_rows or max(4 * num_chunks, 64)
        if cfg.compute == "grad":
            self.num_rows = cfg.batch_size

        self.ledger = RunLedger(n=n, time_scale=cfg.time_scale)
        self.results: dict = {}
        self.decoded_jobs: dict[int, int] = {}
        self.job_done_time: dict[int, float] = {}
        self.decode_max_err = 0.0
        self.measured: list[float] = []
        self.analytic: list[float] = []
        self.g = 0                      # attempted global rounds
        self.epoch_t = 0                # committed rounds in this epoch
        self.epochs_started = 1
        self.stopped = False
        self.ckpt_written: str | None = None
        self.initial_lost: set[int] = set()
        self._rng_state = None
        self.sup: Supervisor | None = None
        self.epoch = self._build_epoch(
            self.scheme_name, self.params,
            np.arange(n), list(range(1, J + 1)), start_round=0,
        )

    # -- construction -----------------------------------------------------
    def _build_epoch(self, name: str, params: dict,
                     survivors: np.ndarray, job_map: list[int],
                     start_round: int) -> _Epoch:
        cfg = self.cfg
        survivors = np.asarray(survivors, dtype=int)
        n_eff = len(survivors)
        sch = make_scheme(name, n_eff, len(job_map), **params)
        rounds = len(job_map) + sch.T
        gate = ConformanceGate(sch.design_model, n_eff)
        alpha = np.asarray(cfg.alpha)
        a_eff = alpha if alpha.ndim == 0 else alpha[survivors]
        extra = (sch.normalized_load - 1.0 / n_eff) * a_eff
        R_full = self.delays.shape[0]
        planned = np.stack([
            self.delays[(start_round + r) % R_full][survivors] + extra
            for r in range(rounds)
        ])
        bounds = tuple(
            chunk_boundaries(self.num_rows, _chunk_fractions(sch))
        )
        truth = TaskComputer(
            cfg.seed, cfg.compute, cfg.dim, self.num_rows, bounds,
            model_cfg=cfg.model_cfg, batch_size=cfg.batch_size,
            seq_len=cfg.seq_len, device=cfg.device,
        ) if cfg.check_decode else None
        return _Epoch(name=name, params=dict(params), sch=sch, gate=gate,
                      survivors=survivors, job_map=list(job_map),
                      planned=planned, start_round=start_round,
                      bounds=bounds, truth=truth)

    def _setup_for(self, wid: int) -> WorkerSetup:
        cfg = self.cfg
        return WorkerSetup(
            worker_id=wid, seed=cfg.seed, compute=cfg.compute,
            dim=cfg.dim, num_rows=self.num_rows, bounds=self.epoch.bounds,
            fault=cfg.faults.get(wid, FaultSpec(delay_mode=cfg.delay_mode)),
            model_cfg=cfg.model_cfg, batch_size=cfg.batch_size,
            seq_len=cfg.seq_len, device=cfg.device,
        )

    def _respawn_setup_for(self, wid: int, attempt: int) -> WorkerSetup:
        cfg = self.cfg
        fault = cfg.respawn_faults.get(
            wid, FaultSpec(delay_mode=cfg.delay_mode)
        )
        return WorkerSetup(
            worker_id=wid, seed=cfg.seed, compute=cfg.compute,
            dim=cfg.dim, num_rows=self.num_rows, bounds=self.epoch.bounds,
            fault=fault, model_cfg=cfg.model_cfg,
            batch_size=cfg.batch_size, seq_len=cfg.seq_len,
            device=cfg.device,
        )

    # -- checkpoint/resume -------------------------------------------------
    def _checkpoint(self) -> None:
        from repro_torch.checkpoint.io import save_blob

        ep = self.epoch
        open_keys = [k for k in self.results
                     if k[1] not in self.decoded_jobs]
        dec_jobs = sorted(self.decoded_jobs)
        state = {
            "version": self.CKPT_VERSION,
            "scheme": self.scheme_name,
            "params": self.params,
            "n": self.n, "J": self.J,
            "num_rows": self.num_rows,
            "seed": self.cfg.seed,
            "global_round": self.g,
            "epochs_started": self.epochs_started,
            "epoch": {
                "scheme": ep.name,
                "params": ep.params,
                "survivors": np.asarray(ep.survivors, dtype=np.int64),
                "job_map": np.asarray(ep.job_map, dtype=np.int64),
                "t": self.epoch_t,
                "start_round": ep.start_round,
                "pattern": np.asarray(ep.gate.history, dtype=bool),
            },
            "lost": np.asarray(self.sup.lost_ids() if self.sup else
                               sorted(self.initial_lost), dtype=np.int64),
            "decoded": {
                "jobs": np.asarray(dec_jobs, dtype=np.int64),
                "rounds": np.asarray(
                    [self.decoded_jobs[j] for j in dec_jobs],
                    dtype=np.int64),
                "times": np.asarray(
                    [self.job_done_time[j] for j in dec_jobs]),
            },
            "decode_max_err": float(self.decode_max_err),
            "measured": np.asarray(self.measured),
            "analytic": np.asarray(self.analytic),
            "results": {
                "keys": [list(k) for k in open_keys],
                "values": [np.asarray(self.results[k]) for k in open_keys],
            },
            "ledger": self.ledger.to_state(),
            "rng": json.dumps(self.sup.rng.bit_generator.state)
                   if self.sup else None,
        }
        self.ckpt_written = save_blob(self.cfg.checkpoint_path, state)

    def restore(self, path: str) -> None:
        """Rebuild mid-sequence state from a checkpoint: scalars and
        arrays load from the blob; gate and scheme state — pure
        functions of the committed history — are reconstructed by
        replaying the admitted-pattern rows, which is what keeps the
        resumed recording bit-identical through ``simulate_fast``."""
        from repro_torch.checkpoint.io import load_blob

        state = load_blob(path)
        if int(state["version"]) != self.CKPT_VERSION:
            raise HarnessError(
                f"unsupported checkpoint version {state['version']!r}"
            )
        if (state["scheme"] != self.scheme_name
                or int(state["n"]) != self.n
                or int(state["J"]) != self.J):
            raise HarnessError(
                "checkpoint does not match this run: "
                f"{state['scheme']}/n={state['n']}/J={state['J']} vs "
                f"{self.scheme_name}/n={self.n}/J={self.J}"
            )
        self.g = int(state["global_round"])
        self.epochs_started = int(state["epochs_started"])
        self.num_rows = int(state["num_rows"])
        eps = state["epoch"]
        self.epoch = self._build_epoch(
            str(eps["scheme"]), dict(eps["params"]),
            np.asarray(eps["survivors"], dtype=int),
            [int(j) for j in eps["job_map"]],
            start_round=int(eps["start_round"]),
        )
        self.epoch_t = int(eps["t"])
        pattern = np.asarray(eps["pattern"], dtype=bool)
        ep = self.epoch
        for r in range(1, self.epoch_t + 1):
            ep.sch.assign(r)
            row = pattern[r - 1]
            if row.any():
                if not ep.gate.admit(row.copy()):
                    raise HarnessError(
                        f"checkpoint gate replay failed at round {r}"
                    )
            else:
                ep.gate.force(row.copy())
            ep.sch.observe(r, row)
            list(ep.sch.collect(r))
        self.initial_lost = {int(x) for x in state["lost"]}
        dec = state["decoded"]
        for j, r, ts in zip(dec["jobs"], dec["rounds"], dec["times"]):
            self.decoded_jobs[int(j)] = int(r)
            self.job_done_time[int(j)] = float(ts)
        self.decode_max_err = float(state["decode_max_err"])
        self.measured = [float(x) for x in state["measured"]]
        self.analytic = [float(x) for x in state["analytic"]]
        self.results = {
            tuple(k): np.asarray(v)
            for k, v in zip(state["results"]["keys"],
                            state["results"]["values"])
        }
        self.ledger = RunLedger.from_state(state["ledger"])
        self._rng_state = (json.loads(state["rng"])
                           if state["rng"] else None)

    # -- the run -----------------------------------------------------------
    def run(self) -> HarnessResult:
        cfg = self.cfg
        aborted, abort_reason = False, None
        self.sup = Supervisor(
            self.n, worker_main, self._setup_for,
            policy=cfg.policy(),
            respawn_setup_for=self._respawn_setup_for,
            start_method=cfg.start_method,
            events=self.ledger.events,
            lost=self.initial_lost,
            seed=cfg.seed,
            transport=cfg.transport,
            net_faults=cfg.net_faults,
        )
        if self._rng_state is not None:
            self.sup.rng.bit_generator.state = self._rng_state
        try:
            self.sup.await_ready(timeout=120.0)
            while self.epoch_t < self.epoch.rounds:
                g = self.g + 1
                try:
                    self._round(self.epoch_t + 1, g)
                    self.epoch_t += 1
                except _DegradeSignal as sig:
                    self._degrade(g, sig.bad)
                self.g = g
                if (cfg.checkpoint_every and cfg.checkpoint_path
                        and g % cfg.checkpoint_every == 0):
                    self._checkpoint()
                if cfg.stop_after_round is not None \
                        and g >= cfg.stop_after_round:
                    self.stopped = True
                    break
        except HarnessError as exc:
            aborted, abort_reason = True, str(exc)
        finally:
            self.sup.stop()

        if not aborted and not self.stopped:
            missing = [j for j in range(1, self.J + 1)
                       if j not in self.decoded_jobs]
            if missing:
                aborted = True
                abort_reason = f"jobs never decoded: {missing[:5]}"

        wc = self.ledger.worker_counters()
        measured = np.asarray(self.measured)
        analytic = np.asarray(self.analytic)
        return HarnessResult(
            scheme=self.epoch.sch.name,
            n=self.n,
            J=self.J,
            time_scale=cfg.time_scale,
            measured_makespan=float(measured.sum()),
            analytic_makespan=float(analytic.sum()),
            round_times=measured,
            analytic_round_times=analytic,
            ledger=self.ledger,
            trace_model=self.ledger.to_trace_model(seed=cfg.seed),
            decoded_jobs=self.decoded_jobs,
            job_done_time=self.job_done_time,
            decode_max_err=self.decode_max_err,
            deaths=self.sup.ever_died(),
            retries=self.ledger.total_retries(),
            waitouts=self.ledger.waitouts(),
            aborted=aborted,
            abort_reason=abort_reason,
            respawns=int(sum(wc["respawns"])),
            rejoins=int(sum(wc["rejoins"])),
            partitions=int(sum(wc["partitions"])),
            heals=int(sum(wc["heals"])),
            degraded=self.epochs_started - 1,
            stopped=self.stopped,
            checkpoint_path=self.ckpt_written,
            events=self.ledger.events,
        )

    # -- one round ---------------------------------------------------------
    def _round(self, t: int, g: int) -> None:
        cfg, ep, sup = self.cfg, self.epoch, self.sup
        sch, gate = ep.sch, ep.gate
        n_eff = ep.n_eff
        surv = ep.survivors
        logical = {int(p): l for l, p in enumerate(surv)}
        sup.begin_round(g)
        sup.pump()                      # stale replies from cancelled work

        tasks = sch.assign(t)
        by_worker: dict[int, list] = {l: [] for l in range(n_eff)}
        for mt in tasks:
            item = _item_for(sch, mt, ep.job_map)
            if item is not None:
                by_worker[mt.worker].append(item)

        times = ep.planned[t - 1]
        kappa = float(times.min())
        cutoff = (1.0 + cfg.mu) * kappa
        tmax = float(times.max())
        base_cand = times > cutoff
        timeout = cfg.round_timeout
        if timeout is None:
            timeout = tmax * cfg.time_scale * 1.5 + 0.25
        hard = cfg.round_hard_timeout
        if hard is None:
            budget = cfg.respawn_max_attempts * (
                cfg.respawn_backoff_max_s + 5.0
            )
            hard = timeout * (cfg.max_retries + 2) + budget + 2.0

        t0 = time.perf_counter()
        rec = self.ledger.new_round(g, t0)
        prow = np.ones(self.n, dtype=bool)
        prow[surv] = base_cand
        rec.planned_row = prow
        last_send = np.full(n_eff, t0)
        round_values: dict[int, list] = {}
        msgs = {}
        for l in range(n_eff):
            p = int(surv[l])
            msgs[l] = {
                "kind": "round", "t": g, "attempt": 0,
                "items": by_worker[l],
                "delay_s": float(times[l]) * cfg.time_scale,
            }
            was_avail = sup.available(p)
            sup.dispatch(p, g, msgs[l])
            if was_avail:
                rec.stats[p].sent = time.perf_counter()
                rec.stats[p].attempts = 1

        # -- wait loop: gather needed results, heartbeat, respawn, retry --
        snapshot = None
        while True:
            for p, msg in sup.pump():
                if msg.get("t") == g and p in logical:
                    st = rec.stats[p]
                    st.reported = time.perf_counter()
                    tel = msg.get("telemetry", {})
                    st.recv = tel.get("recv")
                    st.compute_s = tel.get("compute_s")
                    st.delay_s = tel.get("delay_s")
                    # compute/communication split: the worker measures
                    # the dispatch leg; the return leg comes from the
                    # TCP frame timestamp (or the worker's send stamp)
                    st.wire_send_s = tel.get("wire_s")
                    lag = msg.get("_wire_lag")
                    if lag is None and tel.get("sent") is not None:
                        lag = st.reported - tel["sent"]
                    st.wire_recv_s = lag
                    round_values[logical[p]] = msg["values"]
            down = sup.down_mask()[surv]
            # a worker whose result for THIS round is already in hand
            # served the round — its death affects scheduling from the
            # next dispatch on, exactly like the pre-supervision master
            for l in round_values:
                down[l] = False
            cand = base_cand | down
            cost = np.where(down, np.inf, times)
            eff, waited = _decide(gate, cand, cost)
            bad = [w for w in waited if down[w]]
            now = time.perf_counter()
            if bad:
                recovering = [w for w in bad
                              if sup.recoverable(int(surv[w]))]
                if recovering and now - t0 < hard:
                    # a respawn may still bring the needed worker back:
                    # block on the rejoin rather than giving up
                    sup.tick(waiting_on=[int(surv[w]) for w in bad])
                    wait_any(self._links([l for l in range(n_eff)
                                          if sup.available(int(surv[l]))]),
                             timeout=0.05)
                    continue
                for w in bad:
                    sup.give_up(int(surv[w]))
                if cfg.degrade == "shrink":
                    raise _DegradeSignal([int(surv[w]) for w in bad])
                raise HarnessError(
                    f"round {g}: gate must wait out dead "
                    f"worker(s) {[int(surv[w]) for w in bad]} — "
                    "pattern inadmissible"
                )
            needed = [l for l in range(n_eff)
                      if not eff[l] and not down[l]]
            pending = [l for l in needed if l not in round_values]
            if not pending:
                snapshot = (cand, cost)
                break
            if now - t0 > hard:
                # deadlock guard: whoever is still silent is gone
                for l in pending:
                    sup.mark_dead(int(surv[l]),
                                  reason="round hard deadline")
                continue
            sup.tick(waiting_on=[int(surv[l]) for l in pending])
            wait_any(self._links(pending), timeout=0.02)
            now = time.perf_counter()
            for l in pending:
                p = int(surv[l])
                if l in round_values or not sup.available(p):
                    continue
                if now - last_send[l] > timeout:
                    st = rec.stats[p]
                    if st.attempts <= cfg.max_retries:
                        msg = dict(msgs[l])
                        msg["attempt"] = st.attempts
                        sup.resend(p, msg)
                        st.attempts += 1
                        last_send[l] = now
                        rec.retries += 1
                    else:
                        sup.mark_dead(p, reason="round timeout")

        # mu-rule floor: with candidates present the master cannot
        # know the stragglers before the deadline elapses
        cand, cost = snapshot
        if cand.any():
            remaining = cutoff * cfg.time_scale - (
                time.perf_counter() - t0
            )
            if remaining > 0:
                time.sleep(remaining)
        duration = time.perf_counter() - t0

        # commit the settled decision on the real gate
        if not cand.any():
            gate.force(cand)
            eff, waited = cand.copy(), []
        else:
            eff, waited = gate.admit_partial(cand.copy(), cost)
        erow = np.ones(self.n, dtype=bool)
        erow[surv] = eff
        rec.effective_row = erow
        rec.waited = [int(surv[w]) for w in waited]
        rec.deaths = [ev["worker"] for ev in self.ledger.events
                      # repro: allow[protocol-exhaustiveness]: ledger-event query, not a wire handler — "death" events are appended locally by mark_dead, never sent
                      if ev.get("round") == g and ev["kind"] == "death"]
        rec.duration_s = duration
        rec.analytic_s = _analytic_duration(
            times, cutoff, tmax, cand, eff, waited
        ) * cfg.time_scale
        self.measured.append(duration)
        self.analytic.append(rec.analytic_s)

        for l, values in round_values.items():
            if not eff[l]:              # stragglers' results discarded
                for key, vec in values:
                    self.results[key] = vec
        sch.observe(t, eff)
        for jd in sch.collect(t):
            orig = int(ep.job_map[jd.job - 1])
            gvec = decode_from_results(sch, jd, self.results, job=orig)
            if ep.truth is not None:
                err = float(np.max(np.abs(
                    gvec - ep.truth.full_grad(orig)
                )))
                self.decode_max_err = max(self.decode_max_err, err)
                if err > cfg.decode_atol:
                    raise HarnessError(
                        f"job {orig}: decode error {err:.2e} "
                        f"exceeds atol {cfg.decode_atol:.1e}"
                    )
            self.decoded_jobs[orig] = ep.start_round + jd.round_done
            self.job_done_time[orig] = float(sum(self.measured))

    def _links(self, logicals) -> list:
        out = []
        for l in logicals:
            lk = self.sup.link(int(self.epoch.survivors[l]))
            if lk is not None:
                out.append(lk)
        return out

    # -- adaptive degradation ---------------------------------------------
    def _degrade(self, g: int, bad: list[int]) -> None:
        """Shrink onto the survivors: fresh scheme + encode matrix +
        gate + data partition; un-decoded jobs re-run on the new fleet.
        The abandoned round ``g`` counts toward measured wall clock but
        commits nothing."""
        cfg, ep, sup = self.cfg, self.epoch, self.sup
        rec = self.ledger.records[-1]
        rec.duration_s = time.perf_counter() - rec.start
        self.measured.append(rec.duration_s)
        self.analytic.append(0.0)

        survivors = np.asarray(
            [p for p in ep.survivors if sup.available(int(p))], dtype=int
        )
        if len(survivors) < max(2, cfg.min_workers):
            raise HarnessError(
                f"round {g}: only {len(survivors)} survivors left "
                f"(min_workers={cfg.min_workers})"
            )
        for p in ep.survivors:
            if not sup.available(int(p)):
                sup.retire(int(p))
        remaining = [j for j in ep.job_map if j not in self.decoded_jobs]
        name2, params2 = degrade_params(ep.name, ep.params,
                                        len(survivors))
        try:
            new_epoch = self._build_epoch(
                name2, params2, survivors, remaining, start_round=g
            )
        except HarnessError:
            raise
        # repro: allow[blanket-except]: degradation boundary — any epoch-rebuild failure (scheme construction, partition math) must surface as one HarnessError, not a raw traceback mid-teardown
        except Exception as exc:
            raise HarnessError(
                f"round {g}: degradation to n={len(survivors)} failed: "
                f"{exc}"
            ) from exc
        # results reference the old partition/encode matrix: drop them
        self.results.clear()
        sup.reconfig(new_epoch.bounds)
        self.ledger.events.append({
            "round": int(g), "worker": None, "kind": "degrade",
            "note": (f"{ep.name}/n={ep.n_eff} -> {name2}/"
                     f"n={len(survivors)}, {len(remaining)} jobs re-run"),
        })
        self.epochs_started += 1
        self.epoch = new_epoch
        self.epoch_t = 0


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def run_harness(
    scheme_name: str,
    n: int,
    J: int,
    delays: np.ndarray,
    *,
    params: dict | None = None,
    config: HarnessConfig | None = None,
    resume_from: str | None = None,
) -> HarnessResult:
    """Run ``J`` jobs of ``scheme_name`` over ``n`` real worker
    processes, enacting ``delays`` ((>= J+T rounds, n) planned seconds
    at reference load); returns measured + analytic telemetry.

    ``resume_from`` restores a checkpoint written by a previous run
    with the same scheme/n/J/delays/config (see the module docstring)
    and continues from the round after it."""
    cfg = config or HarnessConfig()
    loop = _MasterLoop(scheme_name, n, J, delays, params, cfg)
    if resume_from is not None:
        loop.restore(resume_from)
    return loop.run()
