"""Round-based runtime simulator + App.-J parameter selection.

Port of ``src/repro/core/simulator.py``.  Reproduces the paper's experimental
accounting:

* reference delay profile: seconds per (round, worker) at load 1/n —
  either sampled from a Gilbert-Elliott source or replayed from a trace;
* load adjustment (App. J / Fig. 16): worker time grows linearly with
  normalized load, ``time = ref + (L - 1/n) * alpha``;
* mu-rule straggler detection (§2): a worker is a straggler in round-t
  when its completion time exceeds ``(1+mu) * kappa(t)`` with kappa the
  fastest worker's time;
* Remark-2.3 wait-out: if the candidate straggler set would push the
  effective pattern outside the scheme's design model, the master waits
  out stragglers that round (selectively, or *all* of them in App. J's
  rule: the round costs ``max`` worker time, and nobody is marked);
* per-round duration: ``min((1+mu)*kappa, max_time)`` without wait-out
  (the master closes the round at the cutoff, cancelling stragglers),
  ``max_time`` with wait-out;
* assertion that every job-t decodes by round-(t+T).

:func:`simulate` is the descriptor path (``assign``/``observe``/``collect``,
numpy on the host): the in-port oracle of the lockstep engine
(``core.batch``), which :func:`select_parameters` runs on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .schemes import Scheme, make_scheme, normalize_scheme_name
from .straggler import ConformanceGate, GilbertElliotSource

__all__ = [
    "SimResult",
    "Candidate",
    "simulate",
    "select_parameters",
    "select_parameters_legacy",
    "estimate_alpha",
    "params_delay",
    "default_grid",
    "reference_profile",
]


@dataclass
class SimResult:
    scheme: str
    total_time: float
    round_times: np.ndarray
    job_done_round: dict[int, int]
    job_done_time: dict[int, float]
    waitouts: int
    effective_pattern: np.ndarray  # (rounds, n) bool
    normalized_load: float

    @property
    def rounds(self) -> int:
        return len(self.round_times)


def simulate(
    scheme: Scheme,
    ref_delays: np.ndarray,
    *,
    mu: float = 1.0,
    alpha: float = 1.0,
    J: int | None = None,
    waitout: str = "selective",  # "selective" (Remark 2.3) | "all" (App. J)
) -> SimResult:
    """Run J jobs through ``scheme`` against the given reference delays.

    ``ref_delays``: (>= J+T rounds, n) seconds at load 1/n.
    ``alpha``: seconds of extra compute per unit of normalized load
    (slope of Fig. 16).
    """
    n = scheme.n
    J = J if J is not None else scheme.J
    rounds = J + scheme.T
    if ref_delays.shape[0] < rounds or ref_delays.shape[1] != n:
        raise ValueError(
            f"need delays of shape (>={rounds}, {n}), got {ref_delays.shape}"
        )

    extra = (scheme.normalized_load - 1.0 / n) * alpha
    gate = ConformanceGate(scheme.design_model, n)
    round_times = np.zeros(rounds)
    job_done_round: dict[int, int] = {}
    job_done_time: dict[int, float] = {}
    waitouts = 0

    for t in range(1, rounds + 1):
        scheme.assign(t)
        times = ref_delays[t - 1] + extra
        kappa = float(times.min())
        cutoff = (1.0 + mu) * kappa
        candidate = times > cutoff
        if not candidate.any():
            gate.force(candidate)
            duration = float(min(cutoff, times.max()))
        elif waitout == "selective":
            candidate, waited = gate.admit_partial(candidate, times)
            if waited:
                waitouts += 1
                base = min(cutoff, times.max()) if candidate.any() else cutoff
                duration = float(max(times[waited].max(), base))
            else:
                duration = float(min(cutoff, times.max()))
        else:  # App-J fallback: wait out all workers on violation
            if gate.admit(candidate):
                duration = float(min(cutoff, times.max()))
            else:
                waitouts += 1
                candidate = np.zeros(n, dtype=bool)
                gate.force(candidate)
                duration = float(times.max())
        scheme.observe(t, candidate)
        round_times[t - 1] = duration
        elapsed = float(round_times[:t].sum())
        for jd in scheme.collect(t):
            job_done_round[jd.job] = jd.round_done
            job_done_time[jd.job] = elapsed

    missing = [j for j in range(1, J + 1) if j not in job_done_round]
    if missing:
        raise AssertionError(f"jobs never finished: {missing[:5]}...")
    late = [j for j, r in job_done_round.items() if r > j + scheme.T]
    if late:
        raise AssertionError(f"jobs past deadline: {late[:5]}")

    return SimResult(
        scheme=scheme.name,
        total_time=float(round_times.sum()),
        round_times=round_times,
        job_done_round=job_done_round,
        job_done_time=job_done_time,
        waitouts=waitouts,
        effective_pattern=gate.history,
        normalized_load=scheme.normalized_load,
    )


def estimate_alpha(source_or_n, base_time: float = 1.0) -> float:
    """Slope of Fig. 16 (time vs load).

    Accepts a ``GilbertElliotSource`` (uses its calibrated slope) or a
    plain worker count (falls back to the paper-like default of
    ``8 * base_time`` seconds per unit load: per-round time on the
    Lambda cluster is overhead-dominated at load 1/n and grows ~8x base
    towards load 1, Fig. 16)."""
    if hasattr(source_or_n, "alpha"):
        return float(source_or_n.alpha)
    return 8.0 * base_time


@dataclass
class Candidate:
    name: str
    params: dict
    load: float = 0.0
    est_time: float = float("inf")


def select_parameters(
    name: str,
    n: int,
    probe_delays: np.ndarray,
    *,
    mu: float = 1.0,
    alpha: float | None = None,
    grid: list[dict] | None = None,
    J: int | None = None,
    seed: int = 0,
    device="cuda",
) -> Candidate:
    """App.-J selection: replay the probe profile under each candidate
    parameterization (load-adjusted) and pick the fastest.

    Runs on the lockstep engine (``core.batch``) on ``device``; picks the
    same candidate as :func:`select_parameters_legacy`, which is kept as
    the differential-testing oracle.
    """
    from .batch import select_parameters_fast

    return select_parameters_fast(
        name, n, probe_delays, mu=mu, alpha=alpha, grid=grid, J=J, seed=seed,
        device=device,
    )


def select_parameters_legacy(
    name: str,
    n: int,
    probe_delays: np.ndarray,
    *,
    mu: float = 1.0,
    alpha: float | None = None,
    grid: list[dict] | None = None,
    J: int | None = None,
    seed: int = 0,
) -> Candidate:
    """Legacy App.-J selection: one full scalar ``simulate`` per grid
    candidate, on the host.  Slow; kept as the oracle for the lockstep
    engine."""
    alpha = alpha if alpha is not None else estimate_alpha(n)
    T_probe = probe_delays.shape[0]
    if grid is None:
        grid = default_grid(name, n)
    best = Candidate(name, {})
    for params in grid:
        maxT = params_delay(name, params)
        J_eff = J if J is not None else max(1, T_probe - maxT)
        if J_eff + maxT > T_probe:
            J_eff = T_probe - maxT
        if J_eff < 1:
            continue
        try:
            scheme = make_scheme(name, n, J_eff, seed=seed, **params)
            res = simulate(scheme, probe_delays, mu=mu, alpha=alpha, J=J_eff)
        except (ValueError, AssertionError):
            continue
        # normalize to per-job time so different T don't skew comparison
        per_job = res.total_time / J_eff
        if per_job < best.est_time:
            best = Candidate(name, params, scheme.normalized_load, per_job)
    if not best.params:
        raise RuntimeError(f"no feasible parameters for scheme {name}")
    return best


def params_delay(name: str, params: dict) -> int:
    """The decode delay T of a scheme's parameters."""
    name = normalize_scheme_name(name)
    if name in ("gc", "dc-gc", "sb-gc", "uncoded", "none", "no-coding"):
        return 0
    if name == "sr-sgc":
        return params["B"]
    if name == "m-sgc":
        return params["W"] - 2 + params["B"]
    raise ValueError(name)


def default_grid(name: str, n: int, max_T: int = 3) -> list[dict]:
    """Small parameter grids mirroring App. J's search space, constrained
    to delay T <= max_T (the paper's multi-model pipelining budget M-1);
    the clustered baselines sweep C in (2, 4, 8) where C | n, and s."""
    name = normalize_scheme_name(name)
    if name == "gc":
        return [{"s": s} for s in range(0, min(n, 33))]
    if name == "sr-sgc":
        out = []
        for B in range(1, max_T + 1):
            for x in range(1, 4):
                W = x * B + 1
                for lam in range(1, min(n, 33)):
                    out.append({"B": B, "W": W, "lam": lam})
        return out
    if name == "m-sgc":
        out = []
        for B in range(1, max_T + 1):
            for W in range(B + 1, B + 4):
                if W - 2 + B > max_T:
                    continue
                for lam in range(0, min(n, 33)):
                    out.append({"B": B, "W": W, "lam": lam})
        return out
    if name in ("dc-gc", "sb-gc"):
        return [
            {"C": C, "s": s}
            for C in (2, 4, 8)
            if n % C == 0
            for s in range(0, min(n // C, 17))
        ]
    if name in ("uncoded", "none", "no-coding"):
        return [{}]
    raise ValueError(name)


def reference_profile(
    n: int, rounds: int, *, seed: int = 0, **ge_kwargs
) -> np.ndarray:
    """Convenience: sample a GE-model reference delay profile."""
    return GilbertElliotSource(n=n, seed=seed, **ge_kwargs).sample_delays(rounds)
