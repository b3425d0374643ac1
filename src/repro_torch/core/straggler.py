"""Straggler models (paper §2.1) and sources.

Port of ``src/repro/core/straggler.py``:

* the window helpers, the models ``StragglerModel``, ``PerRoundModel``,
  ``BurstyModel``, ``ArbitraryModel``, ``MixtureModel``,
  ``RepCoverageModel`` and ``WindowwiseOr``;
* the cluster-capacity models of the Sec.-6 baselines,
  ``DynamicClusterModel`` (dc-gc) and ``StochasticBlockModel`` (sb-gc), and
  their cluster helpers, on numpy arrays and on torch tensors alike;
* ``ConformanceGate``, the numpy Remark-2.3 wait-out gate the trainers run;
* the sources ``GilbertElliotSource``, ``TraceSource``, ``TraceModel`` and
  ``LambdaTraceGenerator``, with the reference's RNG draw order, the
  straggler trace library (``trace_library``, ``Scenario``,
  ``load_recorded_harness``, which reads the port's own copies of the
  recordings in ``recordings/``) and the pattern fits
  (``fit_gilbert_elliot``, ``burst_lengths``, ``suggest_parameters``).
  All of it is numpy RNG: every delay matrix equals the reference's.

The models' batched hooks (``*_batch``) serve the lockstep gate
(``core.kernel.GateKernel``) on torch tensors, on the CPU or on the card.
Their window statistics go through ``kernels.gate_window``: the plain
version for a CPU tensor, the CUDA kernels for a tensor on the card.  In a
grid-fused bucket (``core.batch``) a model's count threshold (``s`` of
``PerRoundModel``, ``DynamicClusterModel`` and ``StochasticBlockModel``,
``lam`` of ``BurstyModel`` and ``ArbitraryModel``) is a ``(cells,)`` tensor,
one value a cell, and every hook broadcasts it per cell (``_per_cell``);
window lengths, ``B``, ``N``, ``C`` and ``RepCoverageModel``'s ``s`` stay
host ints.

Deterministic sliding-window models used for code design:

* ``BurstyModel(B, W, lam)`` — in every window of W consecutive rounds
  there are at most ``lam`` *distinct* stragglers (spatial correlation),
  and per worker the first/last straggling rounds inside the window are
  < B apart (temporal correlation: bursts of length <= B, one burst per
  window).
* ``ArbitraryModel(N, W, lam)`` — at most ``lam`` distinct stragglers
  per window and at most ``N`` straggling rounds per worker per window.
* ``PerRoundModel(s)`` — at most ``s`` stragglers in every round.

Patterns are ``bool`` arrays of shape ``(rounds, n)`` with ``True`` =
straggler (``S_i(t)`` in the paper, transposed to time-major).

All models here are *closed under contiguous sub-patterns*: a pattern
that conforms keeps conforming when rows are removed from either end.
That closure is what makes single-suffix-window incremental admission
(``suffix_ok`` / ``ConformanceGate``) equivalent to re-validating every
window touching the new round.
"""

from __future__ import annotations

import functools
import json
import math
import operator
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels.gate_window import ops as gate_window

__all__ = [
    "BurstyModel",
    "ArbitraryModel",
    "PerRoundModel",
    "MixtureModel",
    "WindowwiseOr",
    "RepCoverageModel",
    "DynamicClusterModel",
    "StochasticBlockModel",
    "ConformanceGate",
    "GilbertElliotSource",
    "TraceSource",
    "TraceModel",
    "LambdaTraceGenerator",
    "Scenario",
    "trace_library",
    "load_recorded_harness",
    "fit_gilbert_elliot",
    "suggest_parameters",
]


def _window_any(pat: np.ndarray, W: int) -> np.ndarray:
    """Per full length-W window: does worker i straggle at all in it?

    Returns bool of shape ``(max(rounds - W + 1, 1), n)``.  Trailing
    partial windows are row-subsets of the last full window, so (by
    sub-pattern closure) they never need separate checking.
    """
    rounds = pat.shape[0]
    if rounds <= W:
        return pat.any(axis=0, keepdims=True)
    cs = np.zeros((rounds + 1, pat.shape[1]), dtype=np.int64)
    np.cumsum(pat, axis=0, out=cs[1:])
    return (cs[W:] - cs[:-W]) > 0


def _window_sum(pat: np.ndarray, W: int) -> np.ndarray:
    """Per full length-W window: straggling-round count per worker."""
    rounds = pat.shape[0]
    if rounds <= W:
        return pat.sum(axis=0, keepdims=True)
    cs = np.zeros((rounds + 1, pat.shape[1]), dtype=np.int64)
    np.cumsum(pat, axis=0, out=cs[1:])
    return cs[W:] - cs[:-W]


def _spatial_min_drops(
    buf: torch.Tensor, cand: torch.Tensor, order: torch.Tensor, lam: int
) -> torch.Tensor:
    """Minimal k (dropping the k first candidates in ``order``) that
    brings the window's distinct-straggler count to <= ``lam``.

    Dropping a candidate removes a distinct straggler iff the worker is
    inactive in the committed ``buf`` rows, so the k-th prefix of the
    drop order fixes the count exactly when it contains enough
    buffer-inactive candidates — a cumulative count over the drop
    order.  Returns ``n + 1`` (sentinel) when no k can help (more
    buffer-active workers than ``lam``; impossible for a member that
    admitted those rows).
    """
    n = cand.shape[1]
    if buf.shape[1]:
        bufact = buf.any(dim=1)
        newc = cand & ~bufact
        m0 = bufact.sum(dim=1)
    else:
        newc = cand
        m0 = 0
    S = newc.sum(dim=1)
    dn = S + m0 - lam                      # drops needed among newc
    cum = torch.cumsum(torch.gather(newc, 1, order), dim=1)
    # first k whose prefix holds enough (argmax of a bool needs an int cast)
    ks = (cum >= dn.clamp_min(1)[:, None]).to(torch.uint8).argmax(dim=1) + 1
    out = torch.where(dn <= 0, 0, ks)
    return torch.where(dn > S, n + 1, out)


def _per_cell(thr, ndim: int):
    """A threshold as it broadcasts against a ``(cells, ...)`` tensor of
    ``ndim`` dims: a host int as it is, a fused per-cell ``(cells,)`` tensor
    (a grid-fused bucket's stacked ``s`` or ``lam``, ``core.batch``) viewed
    as ``(cells, 1, ...)``."""
    if isinstance(thr, torch.Tensor):
        return thr.view(thr.shape + (1,) * (ndim - 1))
    return thr


def _must_drop_min(md: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Minimal k whose drop prefix covers every must-drop worker."""
    return torch.where(md, rank, -1).amax(dim=1) + 1


def _prefix_upto_costliest(md, cand, cost):
    """Candidates at-or-before the costliest must-drop worker in the
    stable ascending-cost greedy order (cost ties break on the smaller
    index, so the costliest must-drop is (max cost, then max index)
    over ``md``).  Empty where ``md`` is empty."""
    idx = torch.arange(cand.shape[1], device=cand.device)[None, :]
    cstar = torch.where(md, cost, -math.inf).amax(dim=1)
    at_star = cost == cstar[:, None]
    istar = torch.where(md & at_star, idx, -1).amax(dim=1)
    return cand & (
        (cost < cstar[:, None]) | (at_star & (idx <= istar[:, None]))
    )


def _window_stats(win: torch.Tensor, B: int):
    """Fused per-cell suffix-window reductions for the batched gate.

    ``win``: (cells, T, n) bool trailing windows.  Returns
    ``(distinct, worker_max, round_max, pair_bad)`` where ``distinct``
    counts workers active anywhere in the window, ``worker_max`` is the
    max per-worker straggling-round count, ``round_max`` the max
    per-round straggler count, and ``pair_bad`` flags a same-worker
    straggle pair >= ``B`` rounds apart (pass ``B >= T`` to skip).

    These four statistics are exactly what the windowed models'
    ``suffix_ok_batch`` verdicts reduce to.  They come from
    ``kernels.gate_window``: the plain version for a CPU tensor, the CUDA
    kernel for a tensor on the card, at every ``n``.
    """
    return gate_window.window_stats(win, B)


def _buffer_stats(buf: torch.Tensor, B: int):
    """Fixed per-round statistics of a committed window buffer
    ``(cells, kh, n)``, computed once per round by the gate's
    specialized admission closures (``admit_fn_batch``):

    ``bufact[c, w]`` — worker straggles somewhere in the buffer;
    ``bufcnt[c, w]`` — its straggling-round count; ``mdmap[c, w]`` —
    a straggle in rows ``0..kh-B`` (would pair-violate, >= ``B``
    apart, with the incoming candidate row at offset ``kh``);
    ``pair_bad[c]`` — a >= ``B``-apart pair already inside the buffer.
    Routed like :func:`_window_stats` (``kernels.gate_window``).
    """
    return gate_window.buffer_stats(buf, B)


class StragglerModel:
    """Interface: validate a full pattern or check incremental conformance.

    The ``*_batch`` hooks are the lockstep gate's (``core.kernel.GateKernel``):
    they take torch tensors with a leading cells axis, on the CPU or the card.
    The models of this module never read them back to the host; a model that
    defines only the numpy ``suffix_ok`` is checked through the host loop of
    the default :meth:`suffix_ok_batch`.
    """

    #: True when the model's verdict is unchanged by dropping all-clear
    #: worker COLUMNS from the pattern (anything counting only straggler
    #: occurrences).  False for models tied to worker identity/layout
    #: (e.g. replication-group coverage).
    column_reducible: bool = False

    #: Closed-form minimal-drop solver for the batched wait-out gate,
    #: or None.  Signature:
    #: ``min_drops_batch(buf, cand, rank, order) -> (rows,) int``
    #: where ``buf`` is this model's trailing committed window rows
    #: ``(rows, kh, n)``, ``cand``/``rank``/``order`` describe the
    #: candidate row and its fixed drop order, and the result is the
    #: smallest k such that dropping the k cheapest candidates makes
    #: the window admissible (``n + 1`` when impossible).  Soundness
    #: requires admissibility to be MONOTONE in the drop prefix, which
    #: holds for any model closed under removing stragglers.  When every
    #: member defines it the gate runs its greedy loop (which calls
    #: :meth:`admit_fn_batch` and :meth:`drops_lower_bound_fn_batch`);
    #: otherwise it checks every drop count's variant with
    #: :meth:`suffix_ok_batch` and assumes no monotonicity.
    min_drops_batch = None

    def conforms(self, pattern: np.ndarray) -> bool:
        raise NotImplementedError

    def drops_lower_bound_fn_batch(self, buf, cost):
        """Rank-free lower bound on this member's minimal wait-out
        drops, specialized (like :meth:`admit_fn_batch`) to the round's
        fixed buffer and cost row: returns ``f(cand) -> (cells,) int``
        (``n + 1``-style sentinels where the member can never admit).
        The gate takes the min over alive members and retires that many
        cheapest candidates per greedy iteration without re-checking
        after each one — sound because no member can admit before its
        own bound is dropped, and drops always proceed in cost order.
        The default (0) is always valid, just slow when wait-outs run
        deep.
        """
        return lambda cand: torch.zeros(cand.shape[0], dtype=torch.int64, device=cand.device)

    def admit_fn_batch(self, buf):
        """Admission specialized to a FIXED committed buffer: returns
        ``f(cand) -> (cells,) bool`` verdicts for the window
        ``buf + cand``.  The gate builds one closure per member per
        round and calls it once per greedy iteration, so overrides
        precompute every buffer-only quantity up front; this default
        re-runs the full suffix check per call.
        """
        if buf.shape[1] == 0:
            return lambda cand: self.suffix_ok_batch(cand[:, None])
        return lambda cand: self.suffix_ok_batch(torch.cat([buf, cand[:, None]], dim=1))

    def suffix_ok(self, win: np.ndarray) -> bool:
        """Is the trailing window ``win`` (bool[<=W, n], last row = the
        candidate round) admissible, assuming every earlier window was
        validated when its own last row was committed?

        By sub-pattern closure this is just ``conforms`` on the suffix;
        windowed models override it with a single-window array check.
        """
        return self.conforms(win)

    #: calls of the host-loop :meth:`suffix_ok_batch` over all models: each
    #: reads its window to the host once (from the card: one device sync)
    host_reads = 0

    def suffix_ok_batch(self, win):
        """Lockstep variant of ``suffix_ok``: ``win`` is a ``(cells, T, n)``
        bool tensor (one trailing window per grid cell, last row = each
        cell's candidate round); returns a ``(cells,)`` bool tensor on
        ``win.device``.

        Every model in this module overrides it with one vectorized pass,
        so the batched gate costs one check per member per round regardless
        of the grid size.  This default is the JAX package's semantics for a
        model whose author wrote only the numpy ``suffix_ok``: it copies the
        window to the host once a call (counted in
        ``StragglerModel.host_reads``) and loops over the cells there.  It
        is not a device path: on the card every call stalls the host on the
        device, and the model's own numpy runs on the CPU.
        """
        StragglerModel.host_reads += 1
        rows = win.cpu().numpy()
        return torch.as_tensor(np.array([self.suffix_ok(w) for w in rows], dtype=bool),
                               device=win.device)

    def admits_round(self, history: np.ndarray, candidate: np.ndarray) -> bool:
        """Would appending ``candidate`` (bool[n]) keep the pattern valid?

        Only windows touching the new round need rechecking; models here
        are windowed, so validating the length-W suffix suffices.
        """
        w = self.window
        rounds = history.shape[0] if history.size else 0
        tail = history[max(0, rounds - (w - 1)) :] if rounds else None
        win = (
            np.concatenate([tail, candidate[None]], axis=0)
            if tail is not None and tail.shape[0]
            else candidate[None]
        )
        return self.suffix_ok(win)

    @property
    def window(self) -> int:
        raise NotImplementedError


@dataclass(frozen=True)
class PerRoundModel(StragglerModel):
    column_reducible = True

    s: int

    def conforms(self, pattern: np.ndarray) -> bool:
        return bool((pattern.sum(axis=1) <= self.s).all())

    def suffix_ok_batch(self, win):
        _, _, round_max, _ = _window_stats(win, win.shape[1])
        return round_max <= self.s

    def min_drops_batch(self, buf, cand, rank, order) -> torch.Tensor:
        k = (cand.sum(dim=1) - self.s).clamp_min(0)
        if buf.shape[1]:
            # inside a multi-round window (WindowwiseOr member): the
            # committed rows must conform too — drops cannot fix them
            hist_ok = (buf.sum(dim=2) <= _per_cell(self.s, 2)).all(dim=1)
            k = torch.where(hist_ok, k, cand.shape[1] + 1)
        return k

    def admit_fn_batch(self, buf):
        if buf.shape[1] == 0:
            return lambda cand: cand.sum(dim=1) <= self.s
        hist_ok = (buf.sum(dim=2) <= _per_cell(self.s, 2)).all(dim=1)
        return lambda cand: hist_ok & (cand.sum(dim=1) <= self.s)

    def drops_lower_bound_fn_batch(self, buf, cost):
        s, sent = self.s, cost.shape[1] + 1
        if buf.shape[1] == 0:
            return lambda cand: (cand.sum(dim=1) - s).clamp_min(0)
        hist_ok = (buf.sum(dim=2) <= _per_cell(s, 2)).all(dim=1)
        return lambda cand: torch.where(hist_ok, (cand.sum(dim=1) - s).clamp_min(0), sent)

    @property
    def window(self) -> int:
        return 1


@dataclass(frozen=True)
class BurstyModel(StragglerModel):
    column_reducible = True

    B: int
    W: int
    lam: int

    def __post_init__(self) -> None:
        if not (1 <= self.B <= self.W):
            raise ValueError(f"need 1 <= B <= W, got B={self.B}, W={self.W}")
        if self.lam < 0:
            raise ValueError("lam must be >= 0")

    def conforms(self, pattern: np.ndarray) -> bool:
        pat = np.asarray(pattern, dtype=bool)
        if pat.shape[0] == 0:
            return True
        # spatial: <= lam distinct stragglers in every window
        if int(_window_any(pat, self.W).sum(axis=1).max()) > self.lam:
            return False
        # temporal: per worker, straggling rounds in a common window span
        # < B.  Two rounds share a window iff they are <= W-1 apart, so a
        # violation is exactly a pair of straggles d in [B, W-1] apart.
        for d in range(self.B, min(self.W, pat.shape[0])):
            if (pat[:-d] & pat[d:]).any():
                return False
        return True

    def suffix_ok(self, win: np.ndarray) -> bool:
        if int(win.any(axis=0).sum()) > self.lam:
            return False
        T = win.shape[0]
        idx = np.arange(T)[:, None]
        first = np.where(win, idx, T).min(axis=0)
        last = np.where(win, idx, -1).max(axis=0)
        # inactive workers give last - first = -1 - T < B automatically
        return bool((last - first < self.B).all())

    def suffix_ok_batch(self, win):
        # temporal: a violation is exactly a same-worker straggle pair
        # >= B rounds apart (mirrors ``conforms``)
        distinct, _, _, pair_bad = _window_stats(win, self.B)
        return (distinct <= self.lam) & ~pair_bad

    def min_drops_batch(self, buf, cand, rank, order) -> torch.Tensor:
        k = _spatial_min_drops(buf, cand, order, self.lam)
        kh = buf.shape[1]
        if kh >= self.B:
            # candidates straggling >= B rounds before the new row can
            # only be fixed by dropping them (window rows 0..kh-B)
            md = cand & buf[:, : kh - self.B + 1].any(dim=1)
            k = torch.maximum(k, _must_drop_min(md, rank))
            # a straggle pair >= B apart WITHIN the committed rows can
            # never be fixed by dropping candidates.  Inside a
            # WindowwiseOr the window may have been admitted through
            # another arm, so this does happen (top-level members are
            # alive-tracked and never see it).
            _, _, _, pair_bad = _buffer_stats(buf, self.B)
            k = torch.where(pair_bad, cand.shape[1] + 1, k)
        return k

    def admit_fn_batch(self, buf):
        if buf.shape[1] == 0:
            return lambda cand: cand.sum(dim=1) <= self.lam
        bufact, _, mdmap, pair_bad = _buffer_stats(buf, self.B)
        base = bufact.sum(dim=1)
        ok_fixed = ~pair_bad

        def f(cand):
            distinct = base + (cand & ~bufact).sum(dim=1)
            return (distinct <= self.lam) & ok_fixed & ~(cand & mdmap).any(dim=1)

        return f

    def drops_lower_bound_fn_batch(self, buf, cost):
        lam, sent = self.lam, cost.shape[1] + 1
        if buf.shape[1] == 0:
            return lambda cand: (cand.sum(dim=1) - lam).clamp_min(0)
        bufact, _, mdmap, pair_bad = _buffer_stats(buf, self.B)
        base = bufact.sum(dim=1)

        def f(cand):
            # spatial shortfall: each drop removes at most one distinct
            # straggler from the window
            distinct = base + (cand & ~bufact).sum(dim=1)
            k = (distinct - lam).clamp_min(0)
            # every candidate at-or-before the costliest must-drop
            # worker is dropped before this member can admit
            md = cand & mdmap
            k = torch.maximum(k, (cand & _prefix_upto_costliest(md, cand, cost)).sum(dim=1))
            return torch.where(pair_bad, sent, k)

        return f

    @property
    def window(self) -> int:
        return self.W


@dataclass(frozen=True)
class ArbitraryModel(StragglerModel):
    column_reducible = True

    N: int
    W: int
    lam: int

    def conforms(self, pattern: np.ndarray) -> bool:
        pat = np.asarray(pattern, dtype=bool)
        if pat.shape[0] == 0:
            return True
        if int(_window_any(pat, self.W).sum(axis=1).max()) > self.lam:
            return False
        return int(_window_sum(pat, self.W).max()) <= self.N

    def suffix_ok(self, win: np.ndarray) -> bool:
        if int(win.any(axis=0).sum()) > self.lam:
            return False
        return int(win.sum(axis=0).max(initial=0)) <= self.N

    def suffix_ok_batch(self, win):
        distinct, worker_max, _, _ = _window_stats(win, win.shape[1])
        return (distinct <= self.lam) & (worker_max <= self.N)

    def min_drops_batch(self, buf, cand, rank, order) -> torch.Tensor:
        k = _spatial_min_drops(buf, cand, order, self.lam)
        # candidates already at N straggling rounds in the window must
        # be dropped (with an empty buffer this still catches N == 0)
        bufcnt = buf.sum(dim=1) if buf.shape[1] else 0
        md = cand & (bufcnt >= self.N)
        k = torch.maximum(k, _must_drop_min(md, rank))
        if buf.shape[1]:
            # a worker already PAST N in the committed rows cannot be
            # fixed by dropping candidates (reachable only inside a
            # WindowwiseOr; top-level members are alive-tracked)
            k = torch.where((bufcnt > self.N).any(dim=1), cand.shape[1] + 1, k)
        return k

    def admit_fn_batch(self, buf):
        if buf.shape[1] == 0:
            if self.N >= 1:
                return lambda cand: cand.sum(dim=1) <= self.lam
            return lambda cand: (cand.sum(dim=1) <= self.lam) & ~cand.any(dim=1)
        bufact, bufcnt, _, _ = _buffer_stats(buf, buf.shape[1] + 1)
        base = bufact.sum(dim=1)
        md = bufcnt >= self.N
        ok_fixed = bufcnt.amax(dim=1) <= self.N

        def f(cand):
            distinct = base + (cand & ~bufact).sum(dim=1)
            return (distinct <= self.lam) & ok_fixed & ~(cand & md).any(dim=1)

        return f

    def drops_lower_bound_fn_batch(self, buf, cost):
        lam, N, sent = self.lam, self.N, cost.shape[1] + 1
        if buf.shape[1] == 0:
            if N == 0:
                # every candidate must go
                return lambda cand: cand.sum(dim=1)
            return lambda cand: (cand.sum(dim=1) - lam).clamp_min(0)
        bufact, bufcnt, _, _ = _buffer_stats(buf, buf.shape[1] + 1)
        base = bufact.sum(dim=1)
        mdmap = bufcnt >= N
        bad = (bufcnt > N).any(dim=1)

        def f(cand):
            distinct = base + (cand & ~bufact).sum(dim=1)
            k = (distinct - lam).clamp_min(0)
            md = cand & mdmap
            k = torch.maximum(k, (cand & _prefix_upto_costliest(md, cand, cost)).sum(dim=1))
            return torch.where(bad, sent, k)

        return f

    @property
    def window(self) -> int:
        return self.W


@dataclass(frozen=True)
class MixtureModel(StragglerModel):
    """Pattern is admissible if it conforms to ANY member model GLOBALLY.

    Used for M-SGC (bursty OR arbitrary, Prop 3.2).  NOTE: a naive
    per-round OR of ``admits_round`` is WRONG — it can weave rounds that
    alternate between members so the final pattern satisfies neither
    model.  Incremental admission must track which members are still
    globally valid; use ``ConformanceGate`` for that.
    """

    members: tuple

    def conforms(self, pattern: np.ndarray) -> bool:
        return any(m.conforms(pattern) for m in self.members)

    def suffix_ok_batch(self, win):
        raise TypeError(
            "MixtureModel admission is stateful; use ConformanceGate "
            "(or the batched GateKernel, which tracks members separately)"
        )

    def admits_round(self, history: np.ndarray, candidate: np.ndarray) -> bool:
        raise TypeError(
            "MixtureModel admission is stateful; use ConformanceGate"
        )

    @property
    def window(self) -> int:
        return max(m.window for m in self.members)


@dataclass(frozen=True)
class RepCoverageModel(StragglerModel):
    """App. G: with the GC-Rep code, a round is tolerable iff every
    replication group of size (s+1) keeps at least one non-straggler —
    a strict superset of the <= s-per-round patterns."""

    n: int
    s: int

    def conforms(self, pattern: np.ndarray) -> bool:
        g = self.s + 1
        groups = pattern.reshape(pattern.shape[0], self.n // g, g)
        return bool((~groups.all(axis=2)).all())

    def suffix_ok_batch(self, win):
        g = self.s + 1
        groups = win.reshape(win.shape[0], win.shape[1], self.n // g, g)
        return ~groups.all(dim=3).any(dim=2).any(dim=1)

    def min_drops_batch(self, buf, cand, rank, order) -> torch.Tensor:
        # a fully-straggling replication group is fixed by dropping its
        # cheapest member, i.e. once the drop prefix reaches the
        # group's minimum rank
        g = self.s + 1
        rows = cand.shape[0]
        candg = cand.reshape(rows, self.n // g, g)
        full = candg.all(dim=2)
        minr = torch.where(candg, rank.reshape(rows, self.n // g, g), self.n).amin(dim=2)
        return torch.where(full, minr + 1, 0).amax(dim=1)

    def admit_fn_batch(self, buf):
        g = self.s + 1

        def f(cand):
            groups = cand.reshape(cand.shape[0], self.n // g, g)
            return ~groups.all(dim=2).any(dim=1)

        return f

    def drops_lower_bound_fn_batch(self, buf, cost):
        # every fully-straggling group needs one (disjoint) drop
        g = self.s + 1

        def f(cand):
            groups = cand.reshape(cand.shape[0], self.n // g, g)
            return groups.all(dim=2).sum(dim=1)

        return f

    @property
    def window(self) -> int:
        return 1


@dataclass(frozen=True)
class WindowwiseOr(StragglerModel):
    """Every length-W window must satisfy at least ONE member predicate
    (members restricted to that window) — Prop 3.1's tolerance class for
    SR-SGC: each window is bursty-conforming OR has <= s stragglers per
    round.  Window predicates are local, so suffix-based incremental
    admission is sound.  Members must be closed under contiguous
    sub-patterns (all models in this module are), which lets both
    ``conforms`` and ``suffix_ok`` check only full windows.
    """

    members: tuple
    W: int

    @property
    def column_reducible(self) -> bool:
        return all(m.column_reducible for m in self.members)

    def conforms(self, pattern: np.ndarray) -> bool:
        pat = np.asarray(pattern, dtype=bool)
        rounds = pat.shape[0]
        if rounds == 0:
            return True
        for j in range(max(rounds - self.W, 0) + 1):
            win = pat[j : j + self.W]
            if not any(m.conforms(win) for m in self.members):
                return False
        return True

    def suffix_ok(self, win: np.ndarray) -> bool:
        return any(m.conforms(win) for m in self.members)

    def suffix_ok_batch(self, win):
        # member suffix_ok == conforms on a single (<= W)-round window
        # for every model in this module, so the OR vectorizes directly
        return functools.reduce(operator.or_, (m.suffix_ok_batch(win) for m in self.members))

    def min_drops_batch(self, buf, cand, rank, order) -> torch.Tensor:
        # the window admits when ANY member does: minimum over members
        # (each sees the full Or-window rows)
        return functools.reduce(
            torch.minimum, (m.min_drops_batch(buf, cand, rank, order) for m in self.members))

    def drops_lower_bound_fn_batch(self, buf, cost):
        # admits via ANY member: the true minimum is the min over
        # member minima, so the bound is the min over member bounds
        fns = [m.drops_lower_bound_fn_batch(buf, cost) for m in self.members]
        return lambda cand: functools.reduce(torch.minimum, (g(cand) for g in fns))

    def admit_fn_batch(self, buf):
        fns = [m.admit_fn_batch(buf) for m in self.members]
        return lambda cand: functools.reduce(operator.or_, (g(cand) for g in fns))

    @property
    def window(self) -> int:
        return self.W


# ---------------------------------------------------------------------------
# cluster-capacity models (scenario-sweep baselines)
# ---------------------------------------------------------------------------


def _round_robin_clusters(prev, C: int):
    """Cluster id per worker from the previous round's straggler row:
    previous stragglers are dealt round-robin across the ``C`` clusters
    first (in worker order), then the remaining workers fill in worker
    order — so bursty stragglers land at most ``ceil(S/C)`` per
    cluster.  ``prev``: (..., n) bool, a numpy array or a torch tensor;
    returns int64 of the same kind and shape.  Pure cumulative sums."""
    strag = prev.cumsum(-1)
    total = strag[..., -1:]
    other = (~prev).cumsum(-1)
    where = torch.where if isinstance(prev, torch.Tensor) else np.where
    return where(prev, strag - 1, total + other - 1) % C


def _cluster_counts_ok(strag, cid, C: int, s: int):
    """Does every cluster keep <= ``s`` stragglers?  ``strag`` is
    (..., n) bool, ``cid`` broadcasts against it (both numpy or both
    torch); reduces the worker axis with a static loop over ``C``."""
    ok = None
    for c in range(C):
        ok_c = (strag & (cid == c)).sum(-1) <= s
        ok = ok_c if ok is None else ok & ok_c
    return ok


def _cluster_min_drops(cand, cid, C: int, s: int, order):
    """Minimal k such that dropping the k first candidates in ``order``
    brings every cluster's straggler count to <= ``s``: per cluster,
    the position in the global drop order where its dropped count
    reaches its shortfall (max over clusters; 0 when none is over).
    Every over-count is fixable by dropping that cluster's own
    candidates, so no sentinel is needed.  Torch tensors (the gate's)."""
    cid = cid.expand(cand.shape)
    cid_o = torch.gather(cid, 1, order)
    cand_o = torch.gather(cand, 1, order)
    out = None
    for c in range(C):
        inc = cand_o & (cid_o == c)
        need = (inc.sum(dim=1) - s).clamp_min(0)
        cum = torch.cumsum(inc, dim=1)
        # first position reaching the shortfall (argmax of a bool needs an int cast)
        kc = (cum >= need.clamp_min(1)[:, None]).to(torch.uint8).argmax(dim=1) + 1
        kc = torch.where(need > 0, kc, 0)
        out = kc if out is None else torch.maximum(out, kc)
    return out


def _cluster_drops_lower_bound(cand, cid, C: int, s: int):
    """Sum of per-cluster shortfalls — a valid lower bound on the drops
    any order needs (each drop decrements exactly one cluster)."""
    out = None
    for c in range(C):
        kc = ((cand & (cid == c)).sum(dim=1) - s).clamp_min(0)
        out = kc if out is None else out + kc
    return out


@dataclass(frozen=True)
class DynamicClusterModel(StragglerModel):
    """Per-round tolerability of dynamic-clustering GC (Buyukates et
    al., arXiv:2011.01922): every round the ``n`` workers are
    re-partitioned into ``C`` clusters from the PREVIOUS round's
    straggler row (:func:`_round_robin_clusters` — past stragglers are
    spread evenly), and the round conforms iff every cluster keeps
    <= ``s`` stragglers.  With no history (round 1 / an all-clear
    previous row) the assignment degenerates to the identity layout
    ``worker i -> cluster i mod C``.

    ``window == 2``: a suffix window's first row fixes the assignment,
    its last row is the candidate — which makes the history dependence
    expressible through the gate's standard rolling-buffer protocol.
    Committed rows need no rechecking (they were admitted under their
    own assignment), so every hook below validates the LAST row only.
    Tied to worker layout, hence not ``column_reducible``.
    """

    n: int
    C: int
    s: int

    def __post_init__(self) -> None:
        if not 1 <= self.C <= self.n:
            raise ValueError(f"need 1 <= C <= n, got C={self.C}")
        if self.n % self.C:
            raise ValueError("DynamicClusterModel requires C | n")
        if not 0 <= self.s < self.n // self.C:
            raise ValueError(
                f"need 0 <= s < n/C = {self.n // self.C}, got s={self.s}"
            )

    def _cid(self, prev):
        return _round_robin_clusters(prev, self.C)

    def _cid_after(self, buf: torch.Tensor) -> torch.Tensor:
        """The candidate row's assignment from a committed buffer
        ``(cells, kh, n)``: its last row, or the identity layout when
        nothing is committed yet."""
        if buf.shape[1]:
            return self._cid(buf[:, -1])
        return torch.arange(self.n, device=buf.device) % self.C

    def conforms(self, pattern: np.ndarray) -> bool:
        pat = np.asarray(pattern, dtype=bool)
        if pat.shape[0] == 0:
            return True
        prev = np.zeros_like(pat)
        prev[1:] = pat[:-1]
        return bool(
            _cluster_counts_ok(pat, self._cid(prev), self.C, self.s).all()
        )

    def suffix_ok(self, win: np.ndarray) -> bool:
        prev = win[-2] if win.shape[0] >= 2 else np.zeros_like(win[-1])
        return bool(
            _cluster_counts_ok(win[-1], self._cid(prev), self.C, self.s)
        )

    def suffix_ok_batch(self, win):
        prev = win[:, -2] if win.shape[1] >= 2 else torch.zeros_like(win[:, -1])
        return _cluster_counts_ok(win[:, -1], self._cid(prev), self.C, self.s)

    def min_drops_batch(self, buf, cand, rank, order) -> torch.Tensor:
        prev = buf[:, -1] if buf.shape[1] else torch.zeros_like(cand)
        return _cluster_min_drops(cand, self._cid(prev), self.C, self.s, order)

    def admit_fn_batch(self, buf):
        cid = self._cid_after(buf)
        return lambda cand: _cluster_counts_ok(cand, cid, self.C, self.s)

    def drops_lower_bound_fn_batch(self, buf, cost):
        cid = self._cid_after(buf)
        return lambda cand: _cluster_drops_lower_bound(cand, cid, self.C, self.s)

    @property
    def window(self) -> int:
        return 2


@dataclass(frozen=True)
class StochasticBlockModel(StragglerModel):
    """Per-round tolerability of stochastic-block GC (Charles &
    Papailiopoulos, arXiv:1805.10378): a FIXED random partition of the
    ``n`` workers into ``C`` equal blocks (drawn from the
    gradient-code seed by the scheme), and a round conforms iff every
    block keeps <= ``s`` stragglers.  ``blocks`` is the length-n tuple
    of block ids — a tuple so the frozen dataclass stays hashable; the
    numpy view is cached at construction and the tensor view once per
    device.  Worker-layout-bound, hence not ``column_reducible``;
    window 1 (memoryless)."""

    n: int
    C: int
    s: int
    blocks: tuple

    def __post_init__(self) -> None:
        if len(self.blocks) != self.n:
            raise ValueError("blocks must assign every worker")
        if not 0 <= self.s < self.n // self.C:
            raise ValueError(
                f"need 0 <= s < n/C = {self.n // self.C}, got s={self.s}"
            )
        object.__setattr__(self, "_bl", np.asarray(self.blocks, dtype=np.int64))
        object.__setattr__(self, "_bl_on", {})

    def _blocks_on(self, device) -> torch.Tensor:
        """The block ids as an int64 tensor on ``device``, built once."""
        bl = self._bl_on.get(device)
        if bl is None:
            bl = self._bl_on[device] = torch.as_tensor(self._bl, device=device)
        return bl

    def conforms(self, pattern: np.ndarray) -> bool:
        pat = np.asarray(pattern, dtype=bool)
        if pat.shape[0] == 0:
            return True
        return bool(
            _cluster_counts_ok(pat, self._bl, self.C, self.s).all()
        )

    def suffix_ok(self, win: np.ndarray) -> bool:
        return self.conforms(win)

    def suffix_ok_batch(self, win):
        bl = self._blocks_on(win.device)
        return _cluster_counts_ok(win, bl, self.C, _per_cell(self.s, 2)).all(dim=1)

    def min_drops_batch(self, buf, cand, rank, order) -> torch.Tensor:
        bl = self._blocks_on(cand.device)
        return _cluster_min_drops(cand, bl, self.C, self.s, order)

    def admit_fn_batch(self, buf):
        bl = self._blocks_on(buf.device)
        return lambda cand: _cluster_counts_ok(cand, bl, self.C, self.s)

    def drops_lower_bound_fn_batch(self, buf, cost):
        bl = self._blocks_on(cost.device)
        return lambda cand: _cluster_drops_lower_bound(cand, bl, self.C, self.s)

    @property
    def window(self) -> int:
        return 1


class _ModelTracker:
    """O(1)-per-round rolling conformance state for one windowed model.

    Keeps only the last ``window - 1`` committed rounds in a fixed
    ring-shifted buffer; ``admits`` is a single vectorized suffix-window
    check instead of re-scanning (and re-concatenating) the whole
    history every round.
    """

    def __init__(self, model: StragglerModel, n: int):
        self.model = model
        self.w = model.window
        self.buf = np.zeros((self.w - 1, n), dtype=bool)
        self.filled = 0  # committed rounds, saturating at w - 1

    def admits(self, candidate: np.ndarray) -> bool:
        k = min(self.filled, self.w - 1)
        if k:
            win = np.concatenate(
                [self.buf[self.w - 1 - k :], candidate[None]], axis=0
            )
        else:
            win = candidate[None]
        return self.model.suffix_ok(win)

    def commit(self, candidate: np.ndarray) -> None:
        if self.w > 1:
            self.buf[:-1] = self.buf[1:]
            self.buf[-1] = candidate
        if self.filled < self.w - 1:
            self.filled += 1


class ConformanceGate:
    """Stateful Remark-2.3 wait-out gate.

    Maintains the effective straggler history and, for mixture models,
    which members are still globally satisfiable (a member that fails
    once is dead forever — conformance violations are permanent).
    ``admit(candidate)`` returns True and commits the round if the
    pattern stays admissible; the caller waits out all stragglers (and
    calls ``admit(zeros)``, which always succeeds) otherwise.

    Per-member state is a rolling ``_ModelTracker``, so each round costs
    O(window * n) array ops regardless of how long the run is.
    """

    def __init__(self, model: StragglerModel, n: int):
        if isinstance(model, MixtureModel):
            self.members = list(model.members)
        else:
            self.members = [model]
        self.alive = [True] * len(self.members)
        self.n = n
        self._trackers = [_ModelTracker(m, n) for m in self.members]
        self._rows: list[np.ndarray] = []
        self._history_cache: np.ndarray | None = None

    @property
    def history(self) -> np.ndarray:
        """Effective pattern committed so far, (rounds, n) bool."""
        if self._history_cache is None:
            if self._rows:
                self._history_cache = np.array(self._rows, dtype=bool)
            else:
                self._history_cache = np.zeros((0, self.n), dtype=bool)
        return self._history_cache

    def _commit(self, row: np.ndarray) -> None:
        row = row.copy()
        self._rows.append(row)
        self._history_cache = None
        for tr in self._trackers:
            tr.commit(row)

    def admit(self, candidate: np.ndarray) -> bool:
        ok = [
            i
            for i, tr in enumerate(self._trackers)
            if self.alive[i] and tr.admits(candidate)
        ]
        if not ok:
            return False
        self.alive = [i in ok for i in range(len(self.members))]
        self._commit(candidate)
        return True

    def force(self, candidate: np.ndarray) -> None:
        """Commit a round unconditionally (used for the all-clear row
        after a wait-out; zeros can never violate any model)."""
        assert not candidate.any()
        self._commit(candidate)

    def admit_partial(
        self, candidate: np.ndarray, cost: np.ndarray
    ) -> tuple[np.ndarray, list[int]]:
        """Selective wait-out (Remark 2.3, refined).

        Greedily waits out (drops from the straggler set) the cheapest
        violating workers until the remaining set is admissible.  The
        master pays ``max(cost[waited])`` extra round time but keeps the
        effective pattern inside the design envelope with minimal
        waiting — strictly better than the App-J "wait out all the
        workers" fallback, which is the degenerate end of this loop.

        Returns (effective straggler set, waited worker ids); commits.
        """
        cand = candidate.copy()
        waited: list[int] = []
        while cand.any():
            ok = [
                i
                for i, tr in enumerate(self._trackers)
                if self.alive[i] and tr.admits(cand)
            ]
            if ok:
                self.alive = [i in ok for i in range(len(self.members))]
                self._commit(cand)
                return cand, waited
            on = np.flatnonzero(cand)
            drop = on[np.argmin(cost[on])]
            cand[drop] = False
            waited.append(int(drop))
        self._commit(cand)
        return cand, waited


@dataclass
class GilbertElliotSource:
    """2-state GE chain per worker (App. C).

    ``p_ns``: P(non-straggler -> straggler); ``p_sn``: P(straggler ->
    non-straggler).  Stationary straggler fraction = p_ns/(p_ns+p_sn).
    Delays: non-straggler times ~ base * (1 + jitter), straggler times
    ~ base * slow_factor * (1 + jitter) — a long right tail mirroring
    Fig. 1(c).
    """

    n: int
    p_ns: float = 0.05
    p_sn: float = 0.6
    base_time: float = 1.0
    slow_factor: float = 4.0
    jitter: float = 0.08
    # Fig. 16 slope: extra seconds per unit of normalized load.  In the
    # paper's Lambda cluster the per-round time is dominated by a fixed
    # overhead (~base_time); full-load compute adds ~8x base on top.
    compute_scale: float = 8.0
    seed: int = 0

    @property
    def alpha(self) -> float:
        return self.base_time * self.compute_scale

    def sample_pattern(self, rounds: int) -> np.ndarray:
        # NB: the RNG draw ORDER (one init draw, then one (rounds, n)
        # block in C order) is a compatibility contract — see
        # tests/test_determinism.py before reordering anything here.
        rng = np.random.default_rng(self.seed)
        state = rng.random(self.n) < self.p_ns / (self.p_ns + self.p_sn)
        flips = rng.random((rounds, self.n))
        out = np.zeros((rounds, self.n), dtype=bool)
        for t in range(rounds):
            out[t] = state
            state = np.where(state, flips[t] >= self.p_sn, flips[t] < self.p_ns)
        return out

    def sample_delays(self, rounds: int) -> np.ndarray:
        """(rounds, n) seconds at the reference load 1/n."""
        rng = np.random.default_rng(self.seed + 1)
        pat = self.sample_pattern(rounds)
        base = self.base_time * (1.0 + self.jitter * rng.standard_normal((rounds, self.n)) ** 2)
        slow = 1.0 + (self.slow_factor - 1.0) * rng.random((rounds, self.n))
        return np.where(pat, base * np.maximum(slow, 1.0), base)


@dataclass
class TraceSource:
    """Replays a recorded (rounds, n) delay matrix (App. J reference profile)."""

    delays: np.ndarray

    def sample_delays(self, rounds: int) -> np.ndarray:
        if rounds > self.delays.shape[0]:
            reps = -(-rounds // self.delays.shape[0])
            return np.tile(self.delays, (reps, 1))[:rounds]
        return self.delays[:rounds]


@dataclass
class TraceModel:
    """Replays a RECORDED per-round straggler pattern as a delay
    source: the bool ``pattern`` (rounds, n) tiles cyclically to any
    horizon (like :class:`TraceSource` does for raw delays), straggler
    slots draw a heavy-tailed slow multiplier, everything else sits at
    ``base_time`` plus jitter.  This is how captured cluster logs (or
    the synthetic recordings shipped in :func:`trace_library`) feed the
    runtime simulator while keeping their exact straggler structure.
    """

    pattern: np.ndarray
    base_time: float = 1.0
    slow_factor: float = 4.0
    jitter: float = 0.05
    compute_scale: float = 8.0
    seed: int = 0
    #: optional measured per-(round, worker) wall-clock seconds from a
    #: real harness run (NaN where no result arrived); carried for
    #: provenance/validation, never consulted by ``sample_delays``
    timings: np.ndarray | None = None
    #: optional supervision event log from an ELASTIC harness run —
    #: ``{"round", "worker", "kind"}`` dicts (kinds: death / respawn /
    #: rejoin / lost / degrade); presence upgrades the recording to
    #: schema v2.  Carried for provenance, never consulted by
    #: ``sample_delays``.
    events: list | None = None

    @property
    def n(self) -> int:
        return self.pattern.shape[1]

    @property
    def alpha(self) -> float:
        return self.base_time * self.compute_scale

    def sample_pattern(self, rounds: int) -> np.ndarray:
        pat = np.asarray(self.pattern, dtype=bool)
        if rounds > pat.shape[0]:
            reps = -(-rounds // pat.shape[0])
            return np.tile(pat, (reps, 1))[:rounds]
        return pat[:rounds]

    def sample_delays(self, rounds: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        pat = self.sample_pattern(rounds)
        base = self.base_time * (
            1.0 + self.jitter * rng.standard_normal((rounds, self.n)) ** 2
        )
        slow = 1.0 + (self.slow_factor - 1.0) * rng.random((rounds, self.n))
        return np.where(pat, base * np.maximum(slow, 1.0), base)

    # -- stable JSON recording schema (versions 1 and 2) -----------------
    #
    #   {"kind": "trace-model", "version": 1, "n", "rounds",
    #    "stragglers": [[worker ids straggling in round t], ...],
    #    "base_time", "slow_factor", "jitter", "compute_scale", "seed",
    #    "timings": null | [[seconds-or-null per worker], ...]}
    #
    # Straggler rows are id lists (patterns are sparse); timings use
    # null for NaN (JSON has no NaN).  Version 2 adds one key to v1:
    # "events" — the elastic harness's supervision log
    # ([{"round", "worker", "kind"}, ...]); recordings without events
    # keep serializing as v1 so checked-in v1 files stay byte-stable.
    # ``from_json(to_json())`` is exact for both versions.

    _REQUIRED_FIELDS = ("n", "rounds", "stragglers", "base_time",
                        "slow_factor", "jitter", "compute_scale", "seed")

    def to_json(self, *, indent: int | None = None) -> str:
        """Serialize the recording (see the schema comment above)."""
        pat = np.asarray(self.pattern, dtype=bool)
        timings = None
        if self.timings is not None:
            tim = np.asarray(self.timings, dtype=np.float64)
            timings = [
                [None if np.isnan(v) else float(v) for v in row]
                for row in tim
            ]
        obj = {
            "kind": "trace-model",
            "version": 2 if self.events is not None else 1,
            "n": int(pat.shape[1]),
            "rounds": int(pat.shape[0]),
            "stragglers": [np.flatnonzero(row).tolist() for row in pat],
            "base_time": float(self.base_time),
            "slow_factor": float(self.slow_factor),
            "jitter": float(self.jitter),
            "compute_scale": float(self.compute_scale),
            "seed": int(self.seed),
            "timings": timings,
        }
        if self.events is not None:
            obj["events"] = self.events
        return json.dumps(obj, indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "TraceModel":
        """Inverse of :meth:`to_json` (exact round-trip).

        Validates the payload up front and raises ``ValueError`` with a
        descriptive message — not a ``KeyError``/``IndexError`` — on a
        foreign payload, an unknown schema version, missing fields, or
        malformed straggler/timing rows."""
        obj = json.loads(text)
        if not isinstance(obj, dict) or obj.get("kind") != "trace-model":
            raise ValueError(
                f"not a trace-model recording: kind={obj.get('kind')!r}"
                if isinstance(obj, dict)
                else f"not a trace-model recording: {type(obj).__name__}"
            )
        version = obj.get("version")
        if version not in (1, 2):
            raise ValueError(
                f"unsupported trace-model schema version {version!r} "
                "(this reader supports versions 1 and 2)"
            )
        missing = [k for k in cls._REQUIRED_FIELDS if k not in obj]
        if missing:
            raise ValueError(
                f"trace-model v{version} recording is missing "
                f"field(s): {missing}"
            )
        rounds, n = int(obj["rounds"]), int(obj["n"])
        stragglers = obj["stragglers"]
        if not isinstance(stragglers, list) or len(stragglers) != rounds:
            raise ValueError(
                f"malformed stragglers: expected {rounds} rows, got "
                f"{len(stragglers) if isinstance(stragglers, list) else type(stragglers).__name__}"
            )
        pat = np.zeros((rounds, n), dtype=bool)
        for t, ids in enumerate(stragglers):
            if not isinstance(ids, list) or not all(
                isinstance(i, int) and 0 <= i < n for i in ids
            ):
                raise ValueError(
                    f"malformed straggler row {t + 1}: want worker ids in "
                    f"[0, {n}), got {ids!r}"
                )
            pat[t, ids] = True
        timings = obj.get("timings")
        if timings is not None:
            if not isinstance(timings, list) or len(timings) != rounds:
                raise ValueError(
                    f"malformed timings: expected {rounds} rows, got "
                    f"{len(timings) if isinstance(timings, list) else type(timings).__name__}"
                )
            for t, row in enumerate(timings):
                if (not isinstance(row, list) or len(row) != n
                        or not all(v is None
                                   or isinstance(v, (int, float))
                                   for v in row)):
                    raise ValueError(
                        f"malformed timing row {t + 1}: want {n} "
                        f"seconds-or-null entries, got {row!r}"
                    )
            timings = np.asarray([
                [np.nan if v is None else float(v) for v in row]
                for row in timings
            ], dtype=np.float64)
        events = obj.get("events") if version >= 2 else None
        if events is not None:
            if not isinstance(events, list) or not all(
                isinstance(ev, dict) and "kind" in ev for ev in events
            ):
                raise ValueError(
                    "malformed events: want a list of dicts with a "
                    "'kind' key"
                )
        return cls(
            pattern=pat,
            base_time=float(obj["base_time"]),
            slow_factor=float(obj["slow_factor"]),
            jitter=float(obj["jitter"]),
            compute_scale=float(obj["compute_scale"]),
            seed=int(obj["seed"]),
            timings=timings,
            events=events,
        )


@dataclass
class LambdaTraceGenerator:
    """AWS-Lambda-like delay synthesizer for the scenario sweeps.

    Captures the serverless-cluster features the GE chain alone does
    not: **cold starts** (a fraction of workers pays a one-off penalty
    on their first round), **platform events** (whole-fleet slowdown
    rounds), and **heterogeneous workers** — per-worker speed factors
    drawn lognormal with sigma ``hetero``, which scale both the base
    latency and the load slope.  :meth:`worker_alpha` exposes that
    slope as a per-worker ``(n,)`` alpha vector; the simulation engines
    accept it anywhere a scalar alpha is accepted (``time = ref +
    (L - 1/n) * alpha_i``), so slow workers get slower *faster* as the
    normalized load grows.  Transient straggling follows the same
    2-state chain as :class:`GilbertElliotSource`.
    """

    n: int
    seed: int = 0
    base_time: float = 1.0
    jitter: float = 0.06
    cold_start: float = 2.5
    cold_fraction: float = 0.7
    p_ns: float = 0.05
    p_sn: float = 0.65
    slow_factor: float = 5.0
    hetero: float = 0.0
    p_event: float = 0.02
    event_factor: float = 2.0
    compute_scale: float = 8.0
    #: fix this to share ONE fleet (one speed draw) across several
    #: generators with different trace seeds; defaults to ``seed + 2``
    speed_seed: int | None = None

    def speed_factors(self) -> np.ndarray:
        """(n,) per-worker speed multipliers (1.0 when homogeneous)."""
        if self.hetero <= 0:
            return np.ones(self.n)
        sseed = self.speed_seed if self.speed_seed is not None else self.seed + 2
        rng = np.random.default_rng(sseed)
        return np.clip(rng.lognormal(0.0, self.hetero, self.n), 0.25, 4.0)

    def worker_alpha(self) -> np.ndarray:
        """(n,) load slope: seconds of extra compute per unit of
        normalized load, per worker (slow workers pay more per chunk)."""
        return self.base_time * self.compute_scale * self.speed_factors()

    @property
    def alpha(self) -> float:
        """Scalar slope (fleet mean) for ``estimate_alpha`` callers."""
        return float(self.worker_alpha().mean())

    def sample_pattern(self, rounds: int) -> np.ndarray:
        # delegate the transient-straggler chain (and its pinned RNG
        # draw-order contract, see GilbertElliotSource) rather than
        # duplicating it
        return GilbertElliotSource(
            n=self.n, seed=self.seed, p_ns=self.p_ns, p_sn=self.p_sn
        ).sample_pattern(rounds)

    def sample_delays(self, rounds: int) -> np.ndarray:
        """(rounds, n) seconds at the reference load 1/n."""
        rng = np.random.default_rng(self.seed + 1)
        pat = self.sample_pattern(rounds)
        speed = self.speed_factors()
        base = self.base_time * speed[None, :] * (
            1.0 + self.jitter * rng.standard_normal((rounds, self.n)) ** 2
        )
        slow = 1.0 + (self.slow_factor - 1.0) * rng.random((rounds, self.n))
        out = np.where(pat, base * np.maximum(slow, 1.0), base)
        cold = rng.random(self.n) < self.cold_fraction
        out[0] = out[0] + np.where(cold, self.cold_start * speed, 0.0)
        events = rng.random(rounds) < self.p_event
        out[events] *= self.event_factor
        return out


_RECORDINGS_DIR = Path(__file__).resolve().parent / "recordings"


def load_recorded_harness(
    name: str = "harness-ge-bursty",
    *,
    n: int | None = None,
    rounds: int | None = None,
) -> TraceModel:
    """Load a checked-in harness recording (JSON written by the JAX
    package's ``repro.dist`` ``RunLedger.to_trace_model().to_json()``)
    from the port's own copies in ``recordings/`` beside this module
    (byte-identical to ``src/repro/core/recordings/``).

    With ``n``/``rounds`` given, the recorded pattern tiles cyclically
    (rows like :meth:`TraceModel.sample_pattern`, columns likewise) to
    the requested fleet shape; the measured ``timings`` are kept only at
    the recording's native shape (they describe specific workers)."""
    path = _RECORDINGS_DIR / f"{name}.json"
    model = TraceModel.from_json(path.read_text())
    pat = np.asarray(model.pattern, dtype=bool)
    reshaped = False
    if rounds is not None and rounds != pat.shape[0]:
        pat = model.sample_pattern(rounds)
        reshaped = True
    if n is not None and n != pat.shape[1]:
        reps = -(-n // pat.shape[1])
        pat = np.tile(pat, (1, reps))[:, :n]
        reshaped = True
    if not reshaped:
        return model
    return TraceModel(
        pattern=pat,
        base_time=model.base_time,
        slow_factor=model.slow_factor,
        jitter=model.jitter,
        compute_scale=model.compute_scale,
        seed=model.seed,
    )


@dataclass(frozen=True)
class Scenario:
    """One named entry of the straggler trace library: a stack of
    reference delay profiles plus the load slope the profiles were
    recorded at (a scalar, or a per-worker ``(n,)`` vector for
    heterogeneous fleets)."""

    name: str
    delays: np.ndarray            # (num_traces, rounds, n)
    alpha: object                 # float | (n,) float array
    note: str = ""


def trace_library(
    n: int = 64,
    rounds: int = 40,
    num_traces: int = 4,
    seed: int = 0,
) -> list[Scenario]:
    """The in-repo straggler trace library the scenario sweeps run on.

    Five qualitatively different worker profiles, all deterministic in
    ``seed`` (``num_traces`` independent traces each):

    * ``ge-bursty`` — the paper's Fig.-1-calibrated GE chain (short
      bursts, ~5% stragglers);
    * ``ge-heavy`` — slower recovery (long bursts, more overlap);
    * ``lambda-cold`` — :class:`LambdaTraceGenerator` with cold starts
      and platform events, homogeneous workers;
    * ``lambda-hetero`` — the same with lognormal worker speeds and the
      matching **per-worker alpha vector** (heterogeneous load slope);
    * ``replayed-waves`` — :class:`TraceModel` replaying a recorded
      diagonal-wave pattern (two adjacent stragglers sweeping the
      fleet), the adversarial-but-structured case cluster logs show;
    * ``recorded-harness`` — :class:`TraceModel` replaying the
      checked-in pattern a real ``repro.dist`` master/worker run
      recorded (see :func:`load_recorded_harness`), tiled cyclically to
      the requested fleet;
    * ``recorded-netfault`` — the same replay machinery over the
      checked-in TCP-transport recording (``harness-tcp-netfault``):
      a real socket run through a mid-run network partition that healed
      (the v2 ``events`` carry the partition/heal transitions), so the
      sweep sees the straggler texture a partitioned-then-healed fleet
      actually produced.
    """

    def _stack(mk):
        return np.stack([mk(k).sample_delays(rounds)
                         for k in range(num_traces)])

    ge_bursty = _stack(lambda k: GilbertElliotSource(
        n=n, seed=seed + 10 * k, p_ns=0.035, p_sn=0.85, slow_factor=6.0,
        jitter=0.05,
    ))
    ge_heavy = _stack(lambda k: GilbertElliotSource(
        n=n, seed=seed + 10 * k + 1, p_ns=0.05, p_sn=0.35, slow_factor=6.0,
        jitter=0.05,
    ))
    cold0 = LambdaTraceGenerator(n=n, seed=seed + 2)
    lam_cold = _stack(lambda k: LambdaTraceGenerator(
        n=n, seed=seed + 10 * k + 2,
    ))
    # ONE fleet (shared speed draw) across the hetero traces, so the
    # scenario's per-worker alpha vector describes every trace
    hetero0 = LambdaTraceGenerator(n=n, seed=seed + 3, hetero=0.35,
                                   speed_seed=seed + 1009)
    lam_het = _stack(lambda k: LambdaTraceGenerator(
        n=n, seed=seed + 10 * k + 3, hetero=0.35,
        speed_seed=seed + 1009,
    ))
    wave = np.zeros((rounds, n), dtype=bool)
    for t in range(rounds):
        wave[t, (2 * t) % n] = wave[t, (2 * t + 1) % n] = True
    wave0 = TraceModel(wave, seed=seed + 4)
    waves = _stack(lambda k: TraceModel(wave, seed=seed + 10 * k + 4))
    rec0 = load_recorded_harness(n=n, rounds=rounds)
    recorded = _stack(lambda k: TraceModel(
        rec0.pattern, base_time=rec0.base_time,
        slow_factor=rec0.slow_factor, jitter=rec0.jitter,
        compute_scale=rec0.compute_scale, seed=seed + 10 * k + 5,
    ))
    net0 = load_recorded_harness("harness-tcp-netfault", n=n,
                                 rounds=rounds)
    netfault = _stack(lambda k: TraceModel(
        net0.pattern, base_time=net0.base_time,
        slow_factor=net0.slow_factor, jitter=net0.jitter,
        compute_scale=net0.compute_scale, seed=seed + 10 * k + 6,
    ))
    # the GE source's calibrated slope; the Lambda/replay scenarios
    # read their own generators' .alpha so a retuned compute scale can
    # never drift from the delays it synthesized
    ge_alpha = GilbertElliotSource(n=n).alpha
    return [
        Scenario("ge-bursty", ge_bursty, ge_alpha,
                 "Fig.-1 calibrated short bursts"),
        Scenario("ge-heavy", ge_heavy, ge_alpha,
                 "long straggler bursts"),
        Scenario("lambda-cold", lam_cold, cold0.alpha,
                 "cold starts + platform events"),
        Scenario("lambda-hetero", lam_het, hetero0.worker_alpha(),
                 "lognormal worker speeds, per-worker alpha"),
        Scenario("replayed-waves", waves, wave0.alpha,
                 "recorded diagonal-wave pattern replay"),
        Scenario("recorded-harness", recorded, rec0.alpha,
                 "real master/worker harness recording replay"),
        Scenario("recorded-netfault", netfault, net0.alpha,
                 "TCP harness recording: partition healed mid-run"),
    ]


def fit_gilbert_elliot(pattern: np.ndarray) -> dict:
    """MLE fit of the 2-state GE chain to an observed straggler pattern
    (App. C: the GE model tracks worker state transitions).

    pattern: bool (rounds, n).  Returns {p_ns, p_sn, stationary,
    mean_burst} — transition MLEs are simple count ratios.
    """
    pat = np.asarray(pattern, dtype=bool)
    prev, nxt = pat[:-1], pat[1:]
    n_to_s = int((~prev & nxt).sum())
    n_stay = int((~prev & ~nxt).sum())
    s_to_n = int((prev & ~nxt).sum())
    s_stay = int((prev & nxt).sum())
    p_ns = n_to_s / max(n_to_s + n_stay, 1)
    p_sn = s_to_n / max(s_to_n + s_stay, 1)
    stationary = p_ns / max(p_ns + p_sn, 1e-12)
    return {
        "p_ns": p_ns,
        "p_sn": p_sn,
        "stationary": stationary,
        "mean_burst": 1.0 / max(p_sn, 1e-12),
    }


def burst_lengths(pattern: np.ndarray) -> np.ndarray:
    """All straggling-run lengths in ``pattern``, worker-major then
    time-ordered (vectorized run-length extraction)."""
    pat = np.asarray(pattern, dtype=bool)
    padded = np.zeros((pat.shape[0] + 2, pat.shape[1]), dtype=bool)
    padded[1:-1] = pat
    starts = ~padded[:-1] & padded[1:]
    ends = padded[:-1] & ~padded[1:]
    _, s_pos = np.nonzero(starts.T)
    _, e_pos = np.nonzero(ends.T)
    return e_pos - s_pos


def suggest_parameters(pattern: np.ndarray, *, quantile: float = 0.95) -> dict:
    """Design-model parameters implied by an observed pattern: smallest
    B covering the burst-length quantile, and per-window distinct
    straggler counts for candidate W (how the paper's Remark-J.1 rule of
    thumb is grounded in data)."""
    pat = np.asarray(pattern, dtype=bool)
    bursts = burst_lengths(pat)
    if bursts.size == 0:
        bursts = np.asarray([0])
    B = int(np.quantile(bursts, quantile)) or 1
    lam_by_W = {}
    for W in (B + 1, 2 * B + 1, 3 * B + 1):
        counts = _window_any(pat, W).sum(axis=1)
        lam_by_W[W] = int(np.quantile(counts, quantile))
    return {"B": B, "lam_by_W": lam_by_W, "burst_q": float(np.quantile(bursts, quantile))}
