"""Straggler models (paper §2.1) and sources.

Port of ``src/repro/core/straggler.py`` without the cluster models, the trace
library and its fitting (ROADMAP.md):

* the window helpers, the models ``StragglerModel``, ``PerRoundModel``,
  ``BurstyModel``, ``ArbitraryModel``, ``MixtureModel``,
  ``RepCoverageModel`` and ``WindowwiseOr``;
* ``ConformanceGate``, the numpy Remark-2.3 wait-out gate the trainers run;
* ``GilbertElliotSource``, with the reference's RNG draw order.

The models' batched hooks (``*_batch``) serve the lockstep gate
(``core.kernel.GateKernel``) on torch tensors, on the CPU or on the card.
Their window statistics go through ``kernels.gate_window``: the plain
version for a CPU tensor, the CUDA kernels for a tensor on the card.

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
import math
import operator
from dataclasses import dataclass

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
    "ConformanceGate",
    "GilbertElliotSource",
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
    they take torch tensors with a leading cells axis, on the CPU or the card,
    and never read them back to the host.
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
    #: holds for any model closed under removing stragglers.  The gate
    #: runs the selective wait-out only over models that define it (it
    #: marks the vectorized members); its greedy loop itself calls
    #: :meth:`admit_fn_batch` and :meth:`drops_lower_bound_fn_batch`.
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

    def suffix_ok_batch(self, win):
        """Lockstep variant of ``suffix_ok``: ``win`` is a ``(cells, T, n)``
        bool tensor (one trailing window per grid cell, last row = each
        cell's candidate round); returns a ``(cells,)`` bool tensor.

        Every model in this module overrides it with one vectorized pass,
        so the batched gate costs one check per member per round regardless
        of the grid size.  A model without one raises here instead of being
        checked cell by cell on the host.
        """
        raise NotImplementedError(
            f"{type(self).__name__} has no vectorized suffix_ok_batch: the lockstep gate over "
            "such a model waits for a later slice of the port (ROADMAP.md: the lockstep "
            "engine's open specs)"
        )

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
            hist_ok = (buf.sum(dim=2) <= self.s).all(dim=1)
            k = torch.where(hist_ok, k, cand.shape[1] + 1)
        return k

    def admit_fn_batch(self, buf):
        if buf.shape[1] == 0:
            return lambda cand: cand.sum(dim=1) <= self.s
        hist_ok = (buf.sum(dim=2) <= self.s).all(dim=1)
        return lambda cand: hist_ok & (cand.sum(dim=1) <= self.s)

    def drops_lower_bound_fn_batch(self, buf, cost):
        s, sent = self.s, cost.shape[1] + 1
        if buf.shape[1] == 0:
            return lambda cand: (cand.sum(dim=1) - s).clamp_min(0)
        hist_ok = (buf.sum(dim=2) <= s).all(dim=1)
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
