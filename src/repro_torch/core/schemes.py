"""Sequential gradient coding schemes (paper §3): GC, SR-SGC, M-SGC and the
uncoded baseline.

Copy of ``src/repro/core/schemes.py`` (numpy only).  Every scheme is a
*round scheduler* with the master-side state machine:

    for t in 1 .. J+T:
        tasks = scheme.assign(t)            # task table for round-t
        ...                                  # workers run, stragglers observed
        scheme.observe(t, straggler_mask)    # bool[n], True = straggler
        done = scheme.collect(t)             # jobs decodable at end of round-t

``assign`` returns per-worker task descriptors rich enough for the real
coded trainer (chunk ids + encode coefficients).

The JAX package's ``step``/``collect_decodes`` advance a 1-cell lockstep
kernel (``core/kernel.py``), which the port leaves out, as it leaves out the
simulator's load-only ``collect_jobs``.  Here they take the reference's own
kernel-less route, the descriptor path above: ``step`` is ``assign`` +
``observe`` and ``collect_decodes`` is ``collect``, listed in job order.
``tests/test_torch_core.py`` holds the ``JobDecode``s of that route equal
to the reference's ``collect_decodes``.

For training, every scheme additionally exposes a static per-(worker,
chunk-slot) view of its decode: ``chunk_grid()`` -> (num_chunks,
slots), ``chunk_slots(job)`` -> (n, slots) global chunk ids, and
``decode_weights(jd)`` -> (n, slots) f32 weights summing to exactly 1
over the slots of every chunk — ``train.coded.make_coded_train_step``
turns that grid into an exact full-batch gradient.

The wait-out rule of Remark 2.3 lives *outside* the scheme (see
``train/driver.py``): the caller must only feed ``observe``/``step``
straggler sets admitted by ``scheme.design_model`` — under that contract
every job-t is decodable by the end of round-(t+T) (Props 3.1 / 3.2),
which ``collect`` asserts.

The clustered baselines dc-gc and sb-gc are not ported yet (ROADMAP.md).

Task descriptor vocabulary (``MiniTask.kind``):
    "ell"  — full (n,s)-GC task: all ``s+1`` cyclic chunks of job-t
             (GC / SR-SGC; a re-attempt iff job < t).
    "d1"   — one private D1 chunk (M-SGC; re-attempt iff ``retry``).
    "d2"   — coded D2 group task: ``lam+1`` chunks of one group (M-SGC).
    "all"  — plain chunk-i computation (uncoded baseline).
    "none" — trivial (job outside [1:J]).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .gc import RepGradientCode, cyclic_support, make_gradient_code
from .straggler import (
    ArbitraryModel,
    BurstyModel,
    MixtureModel,
    PerRoundModel,
    RepCoverageModel,
    WindowwiseOr,
)

__all__ = [
    "MiniTask",
    "JobDecode",
    "Scheme",
    "GCScheme",
    "SRSGCScheme",
    "MSGCScheme",
    "NoCodingScheme",
    "make_scheme",
    "register_scheme",
]


@dataclass(frozen=True)
class MiniTask:
    kind: str          # "ell" | "d1" | "d2" | "all" | "none"
    job: int
    worker: int
    chunk: int = -1    # global chunk id for d1/all; group index m for d2
    retry: bool = False

    @property
    def trivial(self) -> bool:
        return self.kind == "none"


@dataclass
class JobDecode:
    """How the master reconstructs g(job) once decodable.

    ``ell_weights``: {worker: beta} for GC-style results (job-level for
    GC/SR-SGC, per-group for M-SGC in ``group_weights``).
    ``d1_workers``: workers whose private-chunk partial sums enter with
    coefficient 1 (M-SGC g'(t) part / uncoded baseline).
    """

    job: int
    round_done: int
    ell_weights: dict = field(default_factory=dict)
    group_weights: dict = field(default_factory=dict)  # m -> {worker: beta}
    d1_workers: list = field(default_factory=list)


class Scheme:
    name: str = "base"
    n: int
    T: int
    design_model: MixtureModel
    normalized_load: float

    def assign(self, t: int) -> list[MiniTask]:
        raise NotImplementedError

    def observe(self, t: int, stragglers: np.ndarray) -> None:
        raise NotImplementedError

    def collect(self, t: int) -> list[JobDecode]:
        raise NotImplementedError

    # -- the trainer's protocol, on the descriptor route ----------------
    def step(self, t: int, stragglers: np.ndarray) -> None:
        """Assign and observe round-t in one call (the JAX package steps a
        1-cell lockstep kernel here; the port takes its kernel-less route)."""
        self.assign(t)
        self.observe(t, np.asarray(stragglers, dtype=bool))

    def collect_decodes(self, t: int) -> list[JobDecode]:
        """The jobs decodable at round-t, with their decode weights, in job
        order as the JAX package's kernel route lists them (SR-SGC's
        ``collect`` lists job t before job t - B)."""
        return sorted(self.collect(t), key=lambda jd: jd.job)

    # -- coded-trainer surface ------------------------------------------
    # Every scheme maps its decode onto a fixed per-(worker, chunk-slot)
    # weight grid: ``chunk_grid()`` gives (num_chunks, slots),
    # ``chunk_slots(job)`` maps slot (i, j) to a global chunk id, and
    # ``decode_weights(jd)`` returns (n, slots) f32 weights with
    # ``sum over {(i,j): slot(i,j)=c} w[i,j] == 1`` for every chunk c of
    # a decodable job — the weighted all-reduce inside
    # ``train.coded.make_coded_train_step`` is then the exact decoder.
    # Defaults implement the ell-style (n, s+1) layout shared by GC,
    # SR-SGC and the clustered baselines; M-SGC and uncoded override.

    def chunk_grid(self) -> tuple[int, int]:
        """(num_chunks, slots): data chunks per job, chunk slots per
        worker (static for the life of the scheme)."""
        return self.n, self.s + 1

    def _code_at(self, job: int):
        """Gradient code whose encode matrix applies to ``job`` (the
        static ``self.code`` except for round-re-clustered schemes)."""
        return self.code

    def chunk_slots(self, job: int) -> np.ndarray:
        """(n, slots) int64: global chunk id per (worker, slot)."""
        code = self._code_at(job)
        return np.stack(
            [code.chunks_of_worker(i) for i in range(self.n)]
        ).astype(np.int64)

    def decode_weights(self, jd: JobDecode) -> np.ndarray:
        """(n, slots) f32 decode weights for a decoded job:
        ``w[i, j] = beta_i * B[i, chunk(i, j)]`` with all-zero rows for
        workers absent from the decode (stragglers / redundant)."""
        code = self._code_at(jd.job)
        slots = self.chunk_slots(jd.job)
        w = np.zeros(slots.shape, dtype=np.float32)
        B = code.encode_matrix
        for i, beta in jd.ell_weights.items():
            w[i] = beta * B[i, slots[i]]
        return w


# ---------------------------------------------------------------------------
# (n, s)-GC applied round-wise (baseline, §3.1)
# ---------------------------------------------------------------------------


class GCScheme(Scheme):
    name = "gc"

    def __init__(self, n: int, s: int, J: int, *, prefer_rep: bool = True, seed: int = 0):
        self.n, self.s, self.J = n, s, J
        self.T = 0
        self.code = make_gradient_code(n, s, prefer_rep=prefer_rep, seed=seed)
        # App. G: GC-Rep tolerates any pattern leaving one survivor per
        # replication group — a strict superset of <= s per round.
        if isinstance(self.code, RepGradientCode) and s > 0:
            self.design_model = MixtureModel(
                (RepCoverageModel(n, s), PerRoundModel(s))
            )
        else:
            self.design_model = PerRoundModel(s)
        self.normalized_load = (s + 1) / n
        self._returned: dict[int, np.ndarray] = {}  # job -> bool[n] survivors
        self._done: set[int] = set()

    def assign(self, t: int) -> list[MiniTask]:
        if not 1 <= t <= self.J:
            return [MiniTask("none", t, i) for i in range(self.n)]
        return [MiniTask("ell", t, i) for i in range(self.n)]

    def observe(self, t: int, stragglers: np.ndarray) -> None:
        if 1 <= t <= self.J:
            self._returned[t] = ~stragglers

    def _survivors(self, t: int) -> np.ndarray:
        surv = self._returned.get(t)
        return surv if surv is not None else np.zeros(self.n, dtype=bool)

    def _collect_jobs_oracle(self, t: int) -> list[tuple[int, int]]:
        """Descriptor-path decodability check."""
        if t in self._done or not 1 <= t <= self.J:
            return []
        surv = self._survivors(t)
        if not self.code.can_decode_mask(surv):
            raise AssertionError(
                f"GC: job {t} undecodable from {int(surv.sum())} survivors; "
                "caller violated the wait-out contract"
            )
        self._done.add(t)
        return [(t, t)]

    def collect(self, t: int) -> list[JobDecode]:
        jobs = self._collect_jobs_oracle(t)
        out = []
        for job, done_round in jobs:
            surv = np.flatnonzero(self._survivors(job))
            beta = self.code.decode_vector(surv)
            out.append(
                JobDecode(
                    job=job,
                    round_done=done_round,
                    ell_weights={
                        int(w): float(beta[w]) for w in surv if beta[w] != 0.0
                    },
                )
            )
        return out



# ---------------------------------------------------------------------------
# SR-SGC (§3.2, Algorithm 1)
# ---------------------------------------------------------------------------


class SRSGCScheme(Scheme):
    name = "sr-sgc"

    def __init__(self, n: int, B: int, W: int, lam: int, J: int, *,
                 prefer_rep: bool = True, seed: int = 0):
        if B <= 0 or (W - 1) % B != 0:
            raise ValueError("SR-SGC requires B > 0 and B | (W - 1)")
        if not 0 < lam <= n:
            raise ValueError("SR-SGC requires 0 < lam <= n")
        x = (W - 1) // B
        self.n, self.B, self.W, self.lam, self.J = n, B, W, lam, J
        self.s = math.ceil(B * lam / (W - 1 + B))
        assert self.s == math.ceil(lam / (x + 1))
        self.T = B
        self.code = make_gradient_code(n, self.s, prefer_rep=prefer_rep, seed=seed)
        # Prop 3.1: every W-window must be bursty-conforming OR have
        # <= s stragglers per round (window-wise mixture).
        self.design_model = WindowwiseOr(
            (BurstyModel(B, W, lam), PerRoundModel(self.s)), W
        )
        self.normalized_load = (self.s + 1) / n
        # master state (numpy masks so step/observe are vectorized)
        self._returned: dict[int, np.ndarray] = {}      # job -> bool[n] with l_i(job)
        self._returned_in_round: dict[int, int] = {}    # paper's N(t)
        self._assigned: dict[int, np.ndarray] = {}      # round -> int[n] job per worker
        self._done: dict[int, int] = {}                 # job -> round finished
        if isinstance(self.code, RepGradientCode):
            self._groups = np.arange(n) // (self.s + 1)
        else:
            self._groups = None

    def _N(self, t: int) -> int:
        """N(t): # of job-t results returned during round-t (N=n outside [1:J])."""
        if not 1 <= t <= self.J:
            return self.n
        return self._returned_in_round.get(t, 0)

    def _compute_jobs(self, t: int) -> np.ndarray:
        """Algorithm 1 retry rule, vectorized: per-worker job for round-t."""
        n = self.n
        jobs = np.full(n, t, dtype=np.int64)
        tb = t - self.B
        if not 1 <= tb <= self.J:
            return jobs
        prev = self._assigned.get(tb)
        prev_returned = self._returned.get(tb)
        if prev is not None and prev_returned is not None:
            attempted_and_returned = (prev == tb) & prev_returned
        else:
            attempted_and_returned = np.zeros(n, dtype=bool)
        eligible = ~attempted_and_returned
        if self._groups is not None:
            # Algorithm 3 (App. G): skip workers whose replication group's
            # result is already in — no point re-attempting it
            covered = np.zeros(self.code.num_groups, dtype=bool)
            if prev_returned is not None:
                covered[self._groups[prev_returned]] = True
            eligible &= ~covered[self._groups]
        # retries go to eligible workers in worker order until the total
        # returned-or-retrying count delta reaches n - s
        budget = self.n - self.s - self._N(tb)
        retry = eligible & (np.cumsum(eligible) - eligible < budget)
        jobs[retry] = tb
        return jobs

    def assign(self, t: int) -> list[MiniTask]:
        jobs = self._compute_jobs(t)
        self._assigned[t] = jobs
        return [
            MiniTask("ell", int(j), i, retry=bool(j < t)) if 1 <= j <= self.J
            else MiniTask("none", int(j), i)
            for i, j in enumerate(jobs)
        ]

    def _observe_jobs(
        self, t: int, jobs: np.ndarray, stragglers: np.ndarray
    ) -> None:
        ok = ~stragglers
        fresh = 0
        for job in (t, t - self.B):
            if not 1 <= job <= self.J:
                continue
            mask = ok & (jobs == job)
            if job == t:
                fresh = int(mask.sum())
            got = self._returned.get(job)
            if got is None:
                got = self._returned[job] = np.zeros(self.n, dtype=bool)
            got |= mask
        self._returned_in_round[t] = fresh

    def observe(self, t: int, stragglers: np.ndarray) -> None:
        self._observe_jobs(t, self._assigned[t], stragglers)

    def _collect_jobs_oracle(self, t: int) -> list[tuple[int, int]]:
        out = []
        for job in (t, t - self.B):
            if not 1 <= job <= self.J or job in self._done:
                continue
            surv = self._returned.get(job)
            if surv is not None and self.code.can_decode_mask(surv):
                self._done[job] = t
                out.append((job, t))
            elif job == t - self.B:
                raise AssertionError(
                    f"SR-SGC: job {job} missed deadline round {t}; "
                    "caller violated the wait-out contract"
                )
        return out

    def collect(self, t: int) -> list[JobDecode]:
        out = []
        for job, done_round in self._collect_jobs_oracle(t):
            surv = np.flatnonzero(self._returned[job])
            beta = self.code.decode_vector(surv)
            out.append(
                JobDecode(
                    job=job,
                    round_done=done_round,
                    ell_weights={
                        int(w): float(beta[w]) for w in surv if beta[w] != 0.0
                    },
                )
            )
        return out



# ---------------------------------------------------------------------------
# M-SGC (§3.3, Algorithm 2)
# ---------------------------------------------------------------------------


class MSGCScheme(Scheme):
    """Multiplexed SGC with diagonally interleaved mini-tasks.

    Data layout (general scheme, §3.3.2) for dataset of ``d`` points:
      * D1: ``(W-1) * n`` private chunks; worker-i owns global chunks
        ``i*(W-1) .. (i+1)*(W-1)-1``; each has fraction
        ``w1 = (lam+1) / (n * (B + (W-1)(lam+1)))`` of the data.
      * D2: ``B`` groups of ``n`` chunks each protected by an
        (n, lam)-GC; group-m chunk c has global id ``(W-1)*n + m*n + c``
        and fraction ``w2 = w1 / (lam+1)``.
    ``lam == n`` degenerates to D2 = empty (Remark 3.2) with
    ``w1 = 1 / ((W-1) n)``.

    Round-t slot-j (j in [0 : W-2+B]) serves job ``t - j``:
      * j <= W-2: first attempt of D1 local chunk j.
      * j >= W-1 (m = j-W+1): earliest pending failed D1 chunk of that
        job if any, else the group-m coded task ``l_{i,m}(job)``.

    Pending failed D1 chunks are a per-job bool[n, W-1] mask: locals are
    first-attempted in increasing order and retried lowest-first, so the
    queue head is simply the first set bit of a worker's row.
    """

    name = "m-sgc"

    def __init__(self, n: int, B: int, W: int, lam: int, J: int, *,
                 prefer_rep: bool = True, seed: int = 0):
        if not (0 < B < W):
            raise ValueError("M-SGC requires 0 < B < W")
        if not 0 <= lam <= n:
            raise ValueError("M-SGC requires 0 <= lam <= n")
        self.n, self.B, self.W, self.lam, self.J = n, B, W, lam, J
        self.T = W - 2 + B
        self.slots = W - 1 + B
        if lam < n:
            denom = n * (B + (W - 1) * (lam + 1))
            self.w1 = (lam + 1) / denom
            self.w2 = 1.0 / denom
            self.code = make_gradient_code(n, lam, prefer_rep=prefer_rep, seed=seed)
            self.normalized_load = (lam + 1) * (W - 1 + B) / denom
        else:  # Remark 3.2
            self.w1 = 1.0 / ((W - 1) * n)
            self.w2 = 0.0
            self.code = None
            self.normalized_load = (W - 1 + B) / (n * (W - 1))
        self.design_model = MixtureModel(
            (BurstyModel(B, W, lam), ArbitraryModel(B, W + B - 1, lam))
        )
        # master state, keyed by job
        self._pending: dict[int, np.ndarray] = {}    # job -> bool[n, W-1] failed D1
        self._d1_done: dict[int, np.ndarray] = {}    # job -> bool[n, W-1]
        self._d2_returned: dict[int, np.ndarray] = {}  # job -> bool[B, n]
        self._assigned: dict[int, list[list[MiniTask]]] = {}   # round -> [n][slots]
        self._done: dict[int, int] = {}

    # -- chunk id helpers ------------------------------------------------
    def d1_chunk(self, worker: int, local: int) -> int:
        return worker * (self.W - 1) + local

    def d2_group_chunks(self, worker: int, m: int) -> np.ndarray:
        """Global chunk ids of worker's lam+1 chunks within D2 group-m."""
        base = (self.W - 1) * self.n + m * self.n
        return base + cyclic_support(worker, self.lam, self.n)

    @property
    def num_chunks(self) -> int:
        return (self.W - 1) * self.n + (self.B * self.n if self.lam < self.n else 0)

    def chunk_fraction(self, chunk: int) -> float:
        return self.w1 if chunk < (self.W - 1) * self.n else self.w2

    # -- scheduling --------------------------------------------------------
    def _job_state(self, job: int):
        if job not in self._d1_done:
            self._d1_done[job] = np.zeros((self.n, self.W - 1), dtype=bool)
            self._pending[job] = np.zeros((self.n, self.W - 1), dtype=bool)
            self._d2_returned[job] = np.zeros((self.B, self.n), dtype=bool)
        return self._d1_done[job], self._pending[job], self._d2_returned[job]

    def assign(self, t: int) -> list[MiniTask]:
        table: list[list[MiniTask]] = []
        flat: list[MiniTask] = []
        # Within one round, distinct slots serve distinct jobs, so the
        # pending head per (job, worker) is stable across the round.
        for i in range(self.n):
            row = []
            for j in range(self.slots):
                job = t - j
                if not 1 <= job <= self.J:
                    row.append(MiniTask("none", job, i))
                    continue
                _, pend, _ = self._job_state(job)
                if j <= self.W - 2:
                    row.append(MiniTask("d1", job, i, chunk=self.d1_chunk(i, j)))
                    continue
                m = j - (self.W - 1)
                if pend[i].any():
                    head = int(pend[i].argmax())
                    row.append(
                        MiniTask("d1", job, i, chunk=self.d1_chunk(i, head), retry=True)
                    )
                elif self.lam < self.n:
                    row.append(MiniTask("d2", job, i, chunk=m))
                else:
                    row.append(MiniTask("none", job, i))
            table.append(row)
            flat.extend(row)
        self._assigned[t] = table
        return flat

    def observe(self, t: int, stragglers: np.ndarray) -> None:
        table = self._assigned[t]
        for i in range(self.n):
            for mt in table[i]:
                if mt.trivial:
                    continue
                if mt.kind == "d1":
                    local = mt.chunk - i * (self.W - 1)
                    d1, pend, _ = self._job_state(mt.job)
                    if stragglers[i]:
                        if not mt.retry:
                            pend[i, local] = True
                        # retry failure: chunk stays at queue head
                    else:
                        d1[i, local] = True
                        if mt.retry:
                            pend[i, local] = False
                elif mt.kind == "d2" and not stragglers[i]:
                    _, _, d2 = self._job_state(mt.job)
                    d2[mt.chunk, i] = True

    def _decodable(self, job: int) -> tuple[bool, bool]:
        d1, d2 = self._d1_done[job], self._d2_returned[job]
        d1_ok = bool(d1.all())
        d2_ok = self.lam == self.n or bool(
            (d2.sum(axis=1) >= self.n - self.lam).all()
        )
        return d1_ok, d2_ok

    def _collect_jobs_oracle(self, t: int) -> list[tuple[int, int]]:
        out = []
        lo = max(1, t - self.T)
        for job in range(lo, min(t, self.J) + 1):
            if job in self._done or job not in self._d1_done:
                continue
            d1_ok, d2_ok = self._decodable(job)
            if d1_ok and d2_ok:
                self._done[job] = t
                out.append((job, t))
            elif job == t - self.T:
                raise AssertionError(
                    f"M-SGC: job {job} missed deadline round {t} "
                    f"(d1_ok={d1_ok}, d2_ok={d2_ok}); "
                    "caller violated the wait-out contract"
                )
        return out

    def collect(self, t: int) -> list[JobDecode]:
        out = []
        for job, done_round in self._collect_jobs_oracle(t):
            gw = {}
            if self.lam < self.n:
                d2 = self._d2_returned[job]
                for m in range(self.B):
                    surv = np.flatnonzero(d2[m])
                    beta = self.code.decode_vector(surv)
                    gw[m] = {
                        int(w): float(beta[w]) for w in surv if beta[w] != 0.0
                    }
            out.append(
                JobDecode(
                    job=job,
                    round_done=done_round,
                    d1_workers=list(range(self.n)),
                    group_weights=gw,
                )
            )
        return out


    # -- coded-trainer surface (uniform-subchunk expansion) --------------
    # The D1/D2 layout has unequal chunk fractions (w1 = (lam+1) * w2),
    # so the rectangular (n, slots, chunk_bs, ...) coded view splits
    # every D1 chunk into lam+1 equal subchunks of fraction w2: global
    # subchunk ids are D1 chunk c -> [c*(lam+1), (c+1)*(lam+1)) followed
    # by the (already w2-sized) D2 chunks verbatim.  D1 subchunks enter
    # with weight 1 (owner only); group-m subchunks with
    # beta_m[i] * B[i, c] — both sum to exactly 1 per subchunk, so the
    # weighted coded loss decodes the full-batch gradient exactly.

    def chunk_grid(self) -> tuple[int, int]:
        if self.lam == self.n:  # Remark 3.2: no D2, uniform D1 already
            return (self.W - 1) * self.n, self.W - 1
        sub = self.lam + 1
        return (
            (self.W - 1) * self.n * sub + self.B * self.n,
            (self.W - 1 + self.B) * sub,
        )

    def chunk_slots(self, job: int) -> np.ndarray:
        n, W, B, lam = self.n, self.W, self.B, self.lam
        if lam == n:
            return np.stack(
                [np.arange(i * (W - 1), (i + 1) * (W - 1)) for i in range(n)]
            ).astype(np.int64)
        sub = lam + 1
        d2_base = (W - 1) * n * sub
        slots = np.empty((n, (W - 1 + B) * sub), dtype=np.int64)
        for i in range(n):
            row: list[int] = []
            for loc in range(W - 1):
                c = self.d1_chunk(i, loc)
                row.extend(range(c * sub, (c + 1) * sub))
            for m in range(B):
                row.extend(d2_base + m * n + cyclic_support(i, lam, n))
            slots[i] = row
        return slots

    def decode_weights(self, jd: JobDecode) -> np.ndarray:
        n, W, B, lam = self.n, self.W, self.B, self.lam
        _, k = self.chunk_grid()
        w = np.zeros((n, k), dtype=np.float32)
        d1_cols = (W - 1) if lam == n else (W - 1) * (lam + 1)
        for i in jd.d1_workers:
            w[i, :d1_cols] = 1.0
        if lam < n:
            Bmat = self.code.encode_matrix
            sub = lam + 1
            for m, ws in jd.group_weights.items():
                lo = d1_cols + m * sub
                for i, beta in ws.items():
                    sup = cyclic_support(i, lam, n)
                    w[i, lo : lo + sub] = beta * Bmat[i, sup]
        return w


# ---------------------------------------------------------------------------
# scenario-sweep baselines: dynamic-clustering GC and stochastic-block GC
# ---------------------------------------------------------------------------



# ---------------------------------------------------------------------------
# Uncoded baseline
# ---------------------------------------------------------------------------


class NoCodingScheme(Scheme):
    name = "uncoded"

    def __init__(self, n: int, J: int):
        self.n, self.J = n, J
        self.T = 0
        self.design_model = PerRoundModel(0)
        self.normalized_load = 1.0 / n
        self._done: set[int] = set()
        self._returned: dict[int, set[int]] = {}

    def assign(self, t: int) -> list[MiniTask]:
        if not 1 <= t <= self.J:
            return [MiniTask("none", t, i) for i in range(self.n)]
        return [MiniTask("all", t, i, chunk=i) for i in range(self.n)]

    def observe(self, t: int, stragglers: np.ndarray) -> None:
        if 1 <= t <= self.J:
            if stragglers.any():
                raise AssertionError("uncoded scheme tolerates no stragglers")
            self._returned[t] = set(range(self.n))

    def _collect_jobs_oracle(self, t: int) -> list[tuple[int, int]]:
        if t in self._done or not 1 <= t <= self.J:
            return []
        self._done.add(t)
        return [(t, t)]

    def collect(self, t: int) -> list[JobDecode]:
        return [
            JobDecode(job=job, round_done=r, d1_workers=list(range(self.n)))
            for job, r in self._collect_jobs_oracle(t)
        ]

    # -- coded-trainer surface: one private chunk per worker, weight 1 --
    def chunk_grid(self) -> tuple[int, int]:
        return self.n, 1

    def chunk_slots(self, job: int) -> np.ndarray:
        return np.arange(self.n, dtype=np.int64)[:, None]

    def decode_weights(self, jd: JobDecode) -> np.ndarray:
        w = np.zeros((self.n, 1), dtype=np.float32)
        w[jd.d1_workers] = 1.0
        return w


#: user-registered scheme factories: name -> factory(n, J, **kw)
_SCHEME_FACTORIES: dict = {}


def normalize_scheme_name(name: str) -> str:
    """Canonical registry key for a scheme name (casing and
    underscore/dash spelling do not matter)."""
    return name.lower().replace("_", "-")


def register_scheme(name: str, factory) -> None:
    """Register a scheme factory under ``name`` for :func:`make_scheme`
    (the hook new scheme reproductions use)."""
    _SCHEME_FACTORIES[normalize_scheme_name(name)] = factory


def make_scheme(name: str, n: int, J: int, **kw) -> Scheme:
    name = normalize_scheme_name(name)
    if name in _SCHEME_FACTORIES:
        return _SCHEME_FACTORIES[name](n, J, **kw)
    if name == "gc":
        return GCScheme(n, kw.pop("s"), J, **kw)
    if name == "sr-sgc":
        return SRSGCScheme(n, kw.pop("B"), kw.pop("W"), kw.pop("lam"), J, **kw)
    if name == "m-sgc":
        return MSGCScheme(n, kw.pop("B"), kw.pop("W"), kw.pop("lam"), J, **kw)
    if name in ("uncoded", "none", "no-coding"):
        return NoCodingScheme(n, J)
    raise ValueError(f"unknown scheme {name!r}")
