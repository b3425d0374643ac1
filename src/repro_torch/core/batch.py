"""Vectorized batch simulation engine (the App.-J / Table-1 hot path).

Port of ``src/repro/core/batch.py``:

* ``simulate_fast`` — the scalar simulation on the host (numpy): the same
  ``SimResult`` as :func:`simulator.simulate`, stepping the scheme through
  ``step`` and ``collect`` with the O(window * n) rolling ``ConformanceGate``.
* ``simulate_lockstep`` — the **lockstep engine** on a device: every grid
  cell of one spec (one cell per trace) advances through the same round
  together, on the functional scheme kernels and the batched wait-out gate
  of ``core.kernel``.  Traces, times, cutoffs, gate buffers and kernel state
  are tensors on ``device`` (the card unless the caller asks for the CPU), the
  timing math is float64, and the results come back to the host once, at
  the end.
* ``simulate_batch`` — runs a (specs x seeds x traces) grid **grid-fused**
  by default: specs are bucketed by static shape key (:func:`grid_plan`),
  each member's scalar parameters (its normalized load, hence its
  load-adjusted times, and the kernels' ``fused_params``) are stacked along
  the cells axis, and the bucket runs as ONE lockstep round loop over specs
  x traces cells, its results coming to the host once.  The JAX package stacks the same scalars
  under ``vmap``; here a fused threshold is a ``(cells,)`` tensor that the
  kernels and models broadcast per cell.  ``fuse=False`` (or
  ``REPRO_GRID_FUSE=0``) runs one lockstep batch per spec; specs the planner
  cannot stage run that way too, with the same results either way.  Schemes
  whose load-only stepping ignores the coefficient seed (``seed_sensitive =
  False``, all paper schemes) run the trace axis ONCE and share the results
  across the seed axis.
* ``select_parameters_fast`` — the App.-J probe sweep on ``simulate_batch``;
  ``simulator.select_parameters`` delegates here.

The JAX package's compiled-runner cache has no counterpart: nothing is
compiled per spec here.  Every floating-point expression mirrors the JAX
package's numpy engine (same ops, same order); the contract is exact on the
bool/int bookkeeping and allclose on the float times, and on one device the
fused and per-spec paths agree bit for bit.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.devices import resolve_device

from .kernel import GateKernel, SchemeKernel, has_kernel, kernel_seed_sensitive, make_kernel
from .schemes import Scheme, make_scheme
from .simulator import Candidate, SimResult, default_grid, estimate_alpha
from .straggler import ConformanceGate

__all__ = [
    "RoundPrecompute",
    "precompute_rounds",
    "simulate_fast",
    "simulate_lockstep",
    "simulate_batch",
    "select_parameters_fast",
    "grid_plan",
]

@dataclass(frozen=True)
class RoundPrecompute:
    """Per-round timing quantities for one (trace, load) pair.

    ``times[t]`` are the load-adjusted worker seconds of round t+1;
    ``cand[t]`` is the mu-rule candidate straggler mask *before* the
    wait-out gate.  Rows beyond a scheme's horizon are simply unused, so
    one precompute serves schemes with different T.
    """

    times: np.ndarray    # (rounds, n) float
    kappa: np.ndarray    # (rounds,)  fastest worker per round
    cutoff: np.ndarray   # (rounds,)  (1 + mu) * kappa
    tmax: np.ndarray     # (rounds,)  slowest worker per round
    cand: np.ndarray     # (rounds, n) bool
    any_cand: np.ndarray  # (rounds,) bool


def precompute_rounds(ref_delays: np.ndarray, extra: float, mu: float) -> RoundPrecompute:
    """Vectorize the per-round timing math of ``simulate`` over rounds."""
    times = ref_delays + extra
    kappa = times.min(axis=1)
    cutoff = (1.0 + mu) * kappa
    cand = times > cutoff[:, None]
    return RoundPrecompute(times=times, kappa=kappa, cutoff=cutoff, tmax=times.max(axis=1),
                           cand=cand, any_cand=cand.any(axis=1))


def simulate_fast(
    scheme: Scheme,
    ref_delays: np.ndarray,
    *,
    mu: float = 1.0,
    alpha: float = 1.0,
    J: int | None = None,
    waitout: str = "selective",
    pre: RoundPrecompute | None = None,
) -> SimResult:
    """Scalar simulation on the host: the same ``SimResult`` as
    :func:`simulator.simulate`, through ``scheme.step`` and ``collect``.
    ``pre`` lets grid sweeps share the vectorized per-round precompute
    across candidates with the same (trace, load)."""
    n = scheme.n
    J = J if J is not None else scheme.J
    rounds = J + scheme.T
    if ref_delays.shape[0] < rounds or ref_delays.shape[1] != n:
        raise ValueError(f"need delays of shape (>={rounds}, {n}), got {ref_delays.shape}")
    extra = (scheme.normalized_load - 1.0 / n) * alpha
    if pre is None:
        pre = precompute_rounds(ref_delays[:rounds], extra, mu)

    gate = ConformanceGate(scheme.design_model, n)
    round_times = np.zeros(rounds)
    job_done_round: dict[int, int] = {}
    job_done_time: dict[int, float] = {}
    waitouts = 0

    for t in range(1, rounds + 1):
        k = t - 1
        times, cutoff, tmax = pre.times[k], pre.cutoff[k], pre.tmax[k]
        if not pre.any_cand[k]:
            candidate = pre.cand[k]
            gate.force(candidate)
            duration = float(min(cutoff, tmax))
        elif waitout == "selective":
            candidate, waited = gate.admit_partial(pre.cand[k], times)
            if waited:
                waitouts += 1
                base = min(cutoff, tmax) if candidate.any() else cutoff
                duration = float(max(times[waited].max(), base))
            else:
                duration = float(min(cutoff, tmax))
        else:  # App-J fallback: wait out all workers on violation
            if gate.admit(pre.cand[k]):
                candidate = pre.cand[k]
                duration = float(min(cutoff, tmax))
            else:
                waitouts += 1
                candidate = np.zeros(n, dtype=bool)
                gate.force(candidate)
                duration = float(tmax)
        scheme.step(t, candidate)
        round_times[k] = duration
        done = scheme.collect(t)
        if done:
            elapsed = float(round_times[:t].sum())
            for jd in done:
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


def simulate_lockstep(
    name: str,
    params: dict,
    traces: np.ndarray,
    *,
    mu: float = 1.0,
    alpha=1.0,
    J: int | None = None,
    waitout: str = "selective",
    seed: int = 0,
    strict: bool = True,
    device="cuda",
) -> list[SimResult | None]:
    """Advance one spec through MANY traces in lockstep on ``device``.

    One grid cell per trace: the functional kernel state (``core.kernel``)
    and the batched wait-out gate carry a leading cells axis, so each round
    of the whole grid is a handful of tensor ops.  The timing math is
    float64 and replicates the scalar expressions; the round loop reads the
    device only where the gate must decide whether a round has anything to
    wait out (``GateKernel.host_syncs``), and the results come back once.

    ``traces``: (cells, rounds, n).  ``J = None`` fits ``J + T`` inside the
    trace (the App-J rule).  With ``strict=False``, cells whose wait-out
    contract is violated yield ``None`` instead of raising.  ``alpha`` may
    be a scalar or a per-worker ``(n,)`` vector: worker i's round time is
    ``trace + (load - 1/n) * alpha[i]``, the per-cell loads coming from the
    kernel's ``round_loads``: constant for every paper scheme, so the whole
    timing grid is one broadcast pass; a kernel that overrides it
    (load-adaptive) gets each round's times from the state that round
    starts from.  A selective gate whose members lack the analytic
    ``min_drops_batch`` checks drop-count variants (``GateKernel``), and a
    member with only the numpy ``suffix_ok`` is checked on the host
    (``StragglerModel.suffix_ok_batch``), as in the JAX package's numpy
    engine.
    """
    dev = resolve_device(device)
    traces = np.asarray(traces, dtype=np.float64)
    if traces.ndim == 2:
        traces = traces[None]
    cells, rounds_avail, n = traces.shape

    if J is None:
        # probe at the trace length (an upper bound on any fitted J, so
        # constructors that validate J accept it) just to learn T
        probe = make_scheme(name, n, rounds_avail, seed=seed, **dict(params))
        J = _grid_J(rounds_avail, probe.T, None, f"{name} {params}")
    scheme = make_scheme(name, n, J, seed=seed, **dict(params))
    if J + scheme.T > rounds_avail:
        # clamp an explicit J to the trace (the App-J rule, same as _grid_J)
        J = _grid_J(rounds_avail, scheme.T, J, f"{name} {params}")
        scheme = make_scheme(name, n, J, seed=seed, **dict(params))

    kernel = make_kernel(scheme, dev)
    gate = GateKernel(scheme.design_model, n, dev)
    rounds = J + kernel.T
    alpha = np.asarray(alpha, dtype=np.float64)
    traces_dev = torch.as_tensor(traces[:, :rounds], device=dev)
    if type(kernel).round_loads is SchemeKernel.round_loads:
        # the whole timing grid in one broadcast pass: (cells, rounds, n) float64
        extra = (kernel.normalized_load - 1.0 / n) * alpha
        out = _round_loop(kernel, gate, traces_dev + torch.as_tensor(extra, device=dev), mu,
                          waitout)
    else:
        out = _round_loop(kernel, gate, traces_dev, mu, waitout,
                          load_alpha=torch.as_tensor(alpha, device=dev))
    return _assemble_results(kernel.name, scheme.normalized_load, J, *out, strict)


def _round_loop(kernel, gate, times_all, mu, waitout, load_alpha=None):
    """The lockstep round loop over ``times_all`` (cells, rounds, n) float64 on
    the kernel's device: the mu-rule, the wait-out gate and ``kernel.step``
    for every cell of a round at once.  Returns ``(rt, done_round, dead,
    waitouts, history)`` on the host, read back once.  ``calls`` counts the
    loops run, as a kernel wrapper counts its launches.

    ``times_all`` holds the load-adjusted times of a constant-load kernel.
    For a load-adaptive one it holds the bare traces and ``load_alpha`` the
    (scalar or ``(n,)``) alpha: each round's times are then ``traces[:, k] +
    (round_loads - 1/n)[:, None] * alpha``, the JAX package's numpy
    expressions in its order, from the state before that round's ``step``."""
    _round_loop.calls += 1
    cells, rounds, n = times_all.shape
    if load_alpha is None:
        kappa_all = times_all.amin(dim=2)
        cutoff_all = (1.0 + mu) * kappa_all
        tmax_all = times_all.amax(dim=2)
        cand_all = times_all > cutoff_all[..., None]
        any_all = cand_all.any(dim=2)

    state = kernel.init_state(cells)
    gs = gate.init_state(cells)
    rt = torch.zeros((cells, rounds), dtype=torch.float64, device=times_all.device)
    waitouts = torch.zeros(cells, dtype=torch.int64, device=times_all.device)
    for t in range(1, rounds + 1):
        k = t - 1
        if load_alpha is None:
            times, cutoff, tmax = times_all[:, k], cutoff_all[:, k], tmax_all[:, k]
            cand, any_cand = cand_all[:, k], any_all[:, k]
        else:
            # (cells, 1) loads x scalar-or-(n,) alpha; the arithmetic makes a
            # new tensor, so step's in-place updates cannot reach it
            loads = kernel.round_loads(state, t).to(torch.float64)
            times = times_all[:, k] + (loads - 1.0 / n)[:, None] * load_alpha
            kappa = times.amin(dim=1)
            cutoff = (1.0 + mu) * kappa
            tmax = times.amax(dim=1)
            cand = times > cutoff[:, None]
            any_cand = cand.any(dim=1)
        base = torch.minimum(cutoff, tmax)
        if waitout == "selective":
            gs, eff, waited = gate.admit_partial(gs, cand, times, any_cand)
            waited_any = waited.any(dim=1)
            wmax = torch.where(waited, times, -np.inf).amax(dim=1)
            dur_w = torch.maximum(wmax, torch.where(eff.any(dim=1), base, cutoff))
            rt[:, k] = torch.where(waited_any, dur_w, base)
            waitouts += waited_any
        else:  # App-J fallback: wait out all workers on violation
            gs, eff, ok_any = gate.admit_all(gs, cand, any_cand)
            wo = any_cand & ~ok_any
            rt[:, k] = torch.where(wo, tmax, base)
            waitouts += wo
        state = kernel.step(state, t, eff)
    return (rt.cpu().numpy(), state.done_round.cpu().numpy(), state.dead.cpu().numpy(),
            waitouts.cpu().numpy(), torch.stack(gs.history).cpu().numpy())


_round_loop.calls = 0


def _assemble_results(
    scheme_name: str,
    normalized_load: float,
    J: int,
    rt: np.ndarray,
    done_round: np.ndarray,
    dead: np.ndarray,
    waitouts: np.ndarray,
    history: np.ndarray,
    strict: bool,
) -> list[SimResult | None]:
    """Build per-cell ``SimResult``s from lockstep outputs on the host.

    Each job's elapsed time is ``rt[c, :done_round].sum()``: the same
    contiguous-row numpy reduction as the scalar engine's accounting.
    """
    cells = rt.shape[0]
    if strict and bool(dead.any()):
        bad = np.flatnonzero(dead).tolist()
        raise AssertionError(f"{scheme_name}: wait-out contract violated in cell(s) {bad[:5]}")
    results: list[SimResult | None] = []
    for c in range(cells):
        done = done_round[c]
        if bool(dead[c]) or not bool((done[1:] != 0).all()):
            if strict:
                missing = np.flatnonzero(done[1:] == 0) + 1
                raise AssertionError(f"jobs never finished: {missing.tolist()[:5]}...")
            results.append(None)
            continue
        results.append(
            SimResult(
                scheme=scheme_name,
                total_time=float(rt[c].sum()),
                round_times=rt[c].copy(),
                job_done_round={j: int(done[j]) for j in range(1, J + 1)},
                job_done_time={j: float(rt[c, : int(done[j])].sum()) for j in range(1, J + 1)},
                waitouts=int(waitouts[c]),
                effective_pattern=np.ascontiguousarray(history[:, c]),
                normalized_load=normalized_load,
            )
        )
    return results


@dataclass(frozen=True)
class _RunEntry:
    """One (spec, seed) run of a ``simulate_batch`` grid after seed
    deduplication (insensitive schemes keep only ``ki == 0``; the
    result row is shared across the seed axis afterwards)."""

    si: int
    ki: int
    name: str
    params: dict
    J: int
    seed: int


def _plan_entries(specs, traces, seeds, J, strict, out):
    """Per-spec prototypes -> fitted J, seed dedup, run entries.

    Infeasible specs (constructor rejects the grid) raise under
    ``strict`` and mark their ``out`` rows ``None`` otherwise.  Returns
    ``(entries, sensitive)`` where ``sensitive[si]`` drives the
    seed-axis sharing.
    """
    _, rounds_avail, n = traces.shape
    entries: list[_RunEntry] = []
    sensitive_map: dict[int, bool] = {}
    for si, (name, params) in enumerate(specs):
        # one prototype per spec: J, T and normalized_load depend only on
        # the parameters.  Probe at the trace length — an upper bound on
        # any fitted J — so registered schemes that validate J accept it.
        try:
            probe = make_scheme(name, n, rounds_avail, seed=seeds[0], **dict(params))
            J_eff = _grid_J(rounds_avail, probe.T, J, f"{name} {params}")
        except ValueError:
            if strict:
                raise
            out[si] = None
            continue
        sensitive = getattr(probe, "seed_sensitive", False) or kernel_seed_sensitive(probe.name)
        sensitive_map[si] = sensitive
        for ki, seed in enumerate(seeds if sensitive else seeds[:1]):
            entries.append(_RunEntry(si, ki, name, dict(params), J_eff, seed))
    return entries, sensitive_map


@dataclass
class _Bucket:
    """One grid-fusion shape bucket: specs sharing every static shape
    (scheme structure, n, J, T, wait-out, trace count), differing only in
    stacked scalars."""

    key: tuple
    J: int
    T: int
    fused_names: tuple
    scheme0: object                      # representative prototype
    members: list = field(default_factory=list)  # (entry, scheme, scalars)


def _stageable(kernel, gate, waitout: str) -> bool:
    """Can one lockstep round loop run this spec?  The grid-fusion planner
    routes the rest to the per-spec path BEFORE bucketing.  False when
    ``round_loads`` is load-adaptive (the timing grid assumes one constant
    load), or — in the selective wait-out — when a gate member lacks the
    analytic ``min_drops_batch``.  ``gate`` is None in the all-or-nothing
    wait-out, which needs none."""
    if type(kernel).round_loads is not SchemeKernel.round_loads:
        return False
    return gate.analytic if waitout == "selective" else True


def _plan_buckets(entries, traces_shape, waitout, strict, out):
    """Group stageable run entries into shape buckets (the grid-fusion
    planner).  Entries one round loop cannot express — kernel-less schemes
    (``has_kernel``), load-adaptive loads, non-analytic gates — come back as
    leftovers for the per-spec path; entries whose constructor rejects the
    fitted J mark their rows (strict raises).

    The bucket key is the spec's full static signature: scheme name and the
    registered factory and kernel objects, the non-fused ("structural")
    parameters, the fused names, n, J, T, wait-out, the trace count, and —
    for seed-sensitive schemes — the seed.  The kernel's ``fused_params``
    values are excluded: they stack per cell instead.  Host-only: kernels and
    gates are built on the CPU to read their structure.
    """
    from .kernel import _KERNELS
    from .schemes import _SCHEME_FACTORIES

    num_traces, _, n = traces_shape
    leftover: list[_RunEntry] = []
    buckets: dict[tuple, _Bucket] = {}
    for e in entries:
        if not has_kernel(e.name):
            leftover.append(e)
            continue
        try:
            scheme = make_scheme(e.name, n, e.J, seed=e.seed, **dict(e.params))
        except ValueError:
            if strict:
                raise
            out[e.si, e.ki] = [None] * num_traces
            continue
        kern = make_kernel(scheme, "cpu")
        gate = GateKernel(scheme.design_model, scheme.n, "cpu") if waitout == "selective" else None
        if not _stageable(kern, gate, waitout):
            leftover.append(e)
            continue
        fused_names = tuple(kern.fused_params)
        sensitive = getattr(scheme, "seed_sensitive", False) or kernel_seed_sensitive(scheme.name)
        structural = tuple(sorted((str(k), v) for k, v in e.params.items()
                                  if k not in fused_names))
        key = ("grid", scheme.name, _SCHEME_FACTORIES.get(scheme.name),
               _KERNELS.get(scheme.name), structural, fused_names, n, e.J, kern.T, waitout,
               num_traces, e.seed if sensitive else None)
        bucket = buckets.get(key)
        if bucket is None:
            bucket = buckets[key] = _Bucket(key, e.J, kern.T, fused_names, scheme)
        bucket.members.append((e, scheme, kern.fused_scalars(scheme)))
    return leftover, list(buckets.values())


def _simulate_batch_fused(entries, traces, out, *, mu, alpha, waitout, strict, dev):
    """Run the stageable entries bucket by bucket: one round loop over
    members x traces cells (member-major) and one transfer to the host per
    bucket.  Returns the entries left for the per-spec path."""
    leftover, buckets = _plan_buckets(entries, traces.shape, waitout, strict, out)
    num_traces, _, n = traces.shape
    alpha = np.asarray(alpha, dtype=np.float64)
    for b in buckets:
        rounds = b.J + b.T
        kernel = make_kernel(b.scheme0, dev)
        model = kernel.design_model
        if b.fused_names:
            fused = {name: torch.as_tensor([sc[name] for _, _, sc in b.members])
                     .repeat_interleave(num_traces).to(dev) for name in b.fused_names}
            kernel, model = kernel.bind_fused(fused)
        gate = GateKernel(model, n, dev)
        # each member's extra as simulate_lockstep builds it: (load - 1/n) * alpha
        load = np.array([scheme.normalized_load for _, scheme, _ in b.members])
        extra = (load - 1.0 / n)[:, None] * alpha
        times_all = (torch.as_tensor(traces[None, :, :rounds], device=dev)
                     + torch.as_tensor(extra, device=dev)[:, None, None, :])
        rt, done, dead, wo, hist = _round_loop(
            kernel, gate, times_all.reshape(-1, rounds, n), mu, waitout)
        for i, (e, scheme, _) in enumerate(b.members):
            c = slice(i * num_traces, (i + 1) * num_traces)
            out[e.si, e.ki] = _assemble_results(kernel.name, scheme.normalized_load, b.J, rt[c],
                                                done[c], dead[c], wo[c], hist[:, c], strict)
    return leftover


_FUSE_OFF_VALUES = ("0", "false", "off", "no")
_FUSE_ON_VALUES = ("", "1", "true", "on", "yes")


def _fuse_enabled(fuse: bool | None) -> bool:
    """Grid fusion defaults ON, on every device; disable per call
    (``fuse=False``) or per process (``REPRO_GRID_FUSE=0``).  An
    unrecognized value warns instead of silently acting as fuse-ON: a typo
    like ``"nope"`` should not flip the engine's strategy without a trace."""
    if fuse is not None:
        return fuse
    raw = os.environ.get("REPRO_GRID_FUSE", "1").strip().lower()
    if raw in _FUSE_OFF_VALUES:
        return False
    if raw not in _FUSE_ON_VALUES:
        warnings.warn(
            f"REPRO_GRID_FUSE={raw!r} is not a recognized on/off value "
            f"(off: {'/'.join(_FUSE_OFF_VALUES)}; on: 1/true/on/yes); "
            "grid fusion stays ON",
            stacklevel=2,
        )
    return True


def grid_plan(
    specs: list[tuple[str, dict]],
    traces: np.ndarray,
    *,
    seeds: tuple[int, ...] = (0,),
    J: int | None = None,
    waitout: str = "selective",
) -> dict:
    """Dry-run the grid-fusion planner: how would ``simulate_batch`` bucket
    these specs?

    Returns ``{"buckets": [...], "fallback": [...], "infeasible": [...]}``:
    every input spec index lands in exactly one of the three — a bucket dict
    (scheme name, member spec indices, the shared ``J``/``T``, the fused
    parameter names, the trace count), the per-spec ``fallback`` list
    (stageability blockers), or ``infeasible`` (the constructor rejected the
    spec or grid: ``strict=False`` None rows).  Host-only, no device.
    """
    traces = np.asarray(traces, dtype=np.float64)
    if traces.ndim == 2:
        traces = traces[None]
    out = np.empty((len(specs), len(seeds), traces.shape[0]), dtype=object)
    entries, _ = _plan_entries(specs, traces, seeds, J, False, out)
    leftover, buckets = _plan_buckets(entries, traces.shape, waitout, False, out)
    accounted = {e.si for e in leftover}
    for b in buckets:
        accounted.update(e.si for e, _, _ in b.members)
    return {
        "buckets": [
            {
                "scheme": b.scheme0.name,
                "specs": [e.si for e, _, _ in b.members],
                "J": b.J,
                "T": b.T,
                "fused": list(b.fused_names),
                "cells": traces.shape[0],
            }
            for b in buckets
        ],
        # seed-sensitive specs contribute one run entry per seed, but the
        # plan reports spec indices
        "fallback": sorted({e.si for e in leftover}),
        "infeasible": sorted(set(range(len(specs))) - accounted),
    }


def simulate_batch(
    specs: list[tuple[str, dict]],
    traces: np.ndarray,
    *,
    seeds: tuple[int, ...] = (0,),
    mu: float = 1.0,
    alpha=1.0,
    J: int | None = None,
    waitout: str = "selective",
    strict: bool = True,
    device="cuda",
    fuse: bool | None = None,
) -> np.ndarray:
    """Run a (specs x seeds x traces) grid on the lockstep engine.

    ``specs``: [(scheme_name, params_dict), ...]
    ``traces``: (num_traces, rounds, n) reference delay profiles.
    Returns an object array of ``SimResult`` with shape
    ``(len(specs), len(seeds), len(traces))``; with ``strict=False``,
    infeasible cells (bad params / wait-out contract violations) hold
    ``None`` instead of raising.

    The grid runs **grid-fused** by default: specs are bucketed by static
    shape key (scheme structure, n, J, T, wait-out, trace count — see
    :func:`grid_plan`), and each bucket runs as ONE lockstep round loop on
    ``device`` over its specs' traces, its scalar parameters (the normalized
    load and the kernels' ``fused_params``) stacked per cell, with one
    transfer to the host.  ``fuse=False`` (or ``REPRO_GRID_FUSE=0``) runs
    each spec's traces in lockstep on their own (:func:`simulate_lockstep`),
    as do the specs the planner cannot stage; the results are the same
    either way.  Ragged grids are fine — every spec gets its own ``J``/``T``
    (the App-J fit-the-trace rule) and state shapes.
    ``seeds`` vary only the schemes' gradient-code coefficients, which the
    load-only path never reads: for schemes with ``seed_sensitive = False``
    (all paper schemes) the trace axis runs ONCE and the resulting
    ``SimResult`` objects are shared across the seed axis.  Schemes
    registered without a lockstep kernel run per cell through
    :func:`simulate_fast` when ``device`` is the CPU, as in the JAX
    package; on any other device they raise ``NotImplementedError``.
    """
    dev = resolve_device(device)  # up front: strict=False turns ValueErrors into None cells
    traces = np.asarray(traces, dtype=np.float64)
    if traces.ndim == 2:
        traces = traces[None]
    num_traces, _, n = traces.shape

    out = np.empty((len(specs), len(seeds), num_traces), dtype=object)
    entries, sensitive_map = _plan_entries(specs, traces, seeds, J, strict, out)
    if _fuse_enabled(fuse):
        entries = _simulate_batch_fused(entries, traces, out, mu=mu, alpha=alpha,
                                        waitout=waitout, strict=strict, dev=dev)
    for e in entries:
        if has_kernel(e.name):
            # contract violations already yield None cells under
            # strict=False; ValueError covers constructors that reject
            # the fitted J (the probe ran at trace length, an upper bound)
            try:
                row = simulate_lockstep(
                    e.name, e.params, traces, mu=mu, alpha=alpha, J=e.J, waitout=waitout,
                    seed=e.seed, strict=strict, device=dev,
                )
            except ValueError:
                if strict:
                    raise
                row = [None] * num_traces
        elif dev.type != "cpu":
            raise NotImplementedError(
                f"{e.name}: a scheme without a lockstep kernel runs on the host only "
                "(device='cpu'); register one with core.kernel.register_kernel")
        else:
            row = []
            for ti in range(num_traces):
                try:
                    scheme = make_scheme(e.name, n, e.J, seed=e.seed, **dict(e.params))
                    row.append(simulate_fast(scheme, traces[ti], mu=mu, alpha=alpha, J=e.J,
                                             waitout=waitout))
                except (ValueError, AssertionError):
                    if strict:
                        raise
                    row.append(None)
        out[e.si, e.ki] = row
    for si, sensitive in sensitive_map.items():
        if not sensitive:
            # load-only results are seed-invariant: share the SimResult
            # objects (treat as read-only)
            for ki in range(1, len(seeds)):
                out[si, ki] = out[si, 0]
    return out


def _grid_J(rounds_avail: int, maxT: int, J: int | None, what: str) -> int:
    """Legacy App.-J job-count rule: fit J + T inside the trace."""
    J_eff = J if J is not None else max(1, rounds_avail - maxT)
    if J_eff + maxT > rounds_avail:
        J_eff = rounds_avail - maxT
    if J_eff < 1:
        raise ValueError(f"trace of {rounds_avail} rounds too short for {what}")
    return J_eff


def select_parameters_fast(
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
    """App.-J selection on the lockstep engine: replay the probe profile
    under each candidate parameterization (load-adjusted) and pick the
    fastest.  Chooses the same candidate as the legacy per-candidate loop
    (``simulator.select_parameters_legacy``) — same grid order, the same
    per-job times."""
    alpha = alpha if alpha is not None else estimate_alpha(n)
    if grid is None:
        grid = default_grid(name, n)
    res = simulate_batch(
        [(name, params) for params in grid],
        np.asarray(probe_delays, dtype=np.float64)[None],
        seeds=(seed,), mu=mu, alpha=alpha, J=J, strict=False, device=device,
    )
    # grid order is selection order: strict < keeps the earliest on ties,
    # like the legacy loop
    best = Candidate(name, {})
    for gi, params in enumerate(grid):
        r = res[gi, 0, 0]
        if r is None:
            continue
        # normalize to per-job time so different T don't skew comparison
        per_job = r.total_time / len(r.job_done_round)
        if per_job < best.est_time:
            best = Candidate(name, params, r.normalized_load, per_job)
    if not best.params:
        raise RuntimeError(f"no feasible parameters for scheme {name}")
    return best
