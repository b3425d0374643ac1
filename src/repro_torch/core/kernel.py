"""Functional scheme kernels: struct-of-arrays state, lockstep stepping.

Port of ``src/repro/core/kernel.py``.  Where the ``Scheme`` classes in
``schemes.py`` are stateful schedulers advancing ONE run at a time, a
:class:`SchemeKernel` is a round-transition function over a
**struct-of-arrays state with a leading ``cells`` axis**: every independent
grid cell (one (spec, trace) pair of a Monte-Carlo sweep) advances **in
lockstep** through batched tensor ops, so the per-round Python overhead is paid
once per *grid*, not once per *cell*.  Every array is a torch tensor on the
kernel's ``device``: the card unless the caller asks for the CPU.

Protocol::

    kernel = make_kernel(scheme, device)     # from a Scheme prototype
    state  = kernel.init_state(cells)        # struct-of-arrays, (cells, ...)
    loads  = kernel.round_loads(state, t)    # (cells,) normalized loads
    state  = kernel.step(state, t, stragglers)   # stragglers: (cells, n)

``step`` fuses ``assign`` + ``observe`` + ``collect``: it advances the master
bookkeeping for round ``t`` and marks every job that became decodable this
round in ``state.done_round`` (and cells that violated the wait-out contract in
``state.dead``).  It updates the state in place and never reads a tensor back
to the host: round indices are host ints, so only data-free branches remain.

:class:`GateKernel` gives the Remark-2.3 wait-out gate
(``straggler.ConformanceGate``) the same treatment: per-member rolling suffix
windows and alive flags carry a leading cells axis.  Its selective wait-out is
the JAX package's branch-free greedy form (``_admit_partial_traced``), with a
Python loop for ``lax.while_loop``: one host check per round and one per
greedy iteration, the same code on the CPU and on the card.

The clustered baselines' kernels (``DCGCKernel``, ``SBGCKernel``) come with
their schemes in a later slice (ROADMAP.md); ``make_kernel`` raises
``KeyError`` for them, as for any unregistered scheme.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from repro_torch.devices import resolve_device

from .straggler import MixtureModel, StragglerModel, WindowwiseOr

__all__ = [
    "SchemeState",
    "SchemeKernel",
    "GCKernel",
    "SRSGCKernel",
    "MSGCKernel",
    "UncodedKernel",
    "GateState",
    "GateKernel",
    "make_kernel",
    "register_kernel",
    "has_kernel",
    "kernel_seed_sensitive",
]


# ---------------------------------------------------------------------------
# states
# ---------------------------------------------------------------------------


@dataclass
class SchemeState:
    """Base struct-of-arrays state; every tensor has a leading cells axis.

    ``done_round[c, j]`` is the round job-j of cell-c became decodable
    (0 = pending; column 0 unused so jobs index 1-based, like the
    paper).  ``dead[c]`` marks cells whose wait-out contract was
    violated (a job missed its round-(t+T) deadline) — their results
    are invalid and the engine either raises (strict) or yields None.
    """

    done_round: torch.Tensor  # (cells, J+1) int64
    dead: torch.Tensor        # (cells,) bool

    @property
    def cells(self) -> int:
        return self.dead.shape[0]


@dataclass
class GCState(SchemeState):
    pass


@dataclass
class SRSGCState(SchemeState):
    """Ring buffers over ``B + 1`` slots indexed by ``key % (B+1)``:
    job-keyed for ``returned``/``n_fresh``, round-keyed for
    ``assigned`` (a job/round key is live for <= B+1 rounds)."""

    returned: torch.Tensor  # (cells, B+1, n) bool  l_i(job) returned
    assigned: torch.Tensor  # (cells, B+1, n) int64 per-worker job of round
    n_fresh: torch.Tensor   # (cells, B+1) int64    paper's N(job)


@dataclass
class MSGCState(SchemeState):
    """Job-keyed ring buffers over ``slots = W-1+B = T+1`` entries.

    There is no explicit completed-D1 array: chunk (w, j) of a job is
    done iff its first attempt happened (round ``job + j``) and it is
    not in the failed-chunk queue — failures enqueue in ``pend`` at the
    first attempt and leave it only on a successful retry — so D1
    completeness is ``t >= job + W - 2  and  not pend.any()``.
    """

    pend: torch.Tensor       # (cells, slots, n, W-1) bool failed-D1 queue
    d2: torch.Tensor | None  # (cells, slots, B, n) bool; None when lam == n


@dataclass
class UncodedState(SchemeState):
    pass


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


class SchemeKernel:
    """Functional round scheduler over a cells axis.

    Subclasses read all static parameters off a ``Scheme`` prototype at
    construction (reusing its validation) and implement ``init_state`` /
    ``step``.  ``seed_sensitive`` declares whether the load-only stepping
    depends on the gradient-code seed — the batch engine deduplicates the
    seed axis when it is False (true for every scheme in the paper:
    coefficients never enter the timing math).
    """

    name: str = "base"
    seed_sensitive: bool = False

    def __init__(self, scheme, device="cuda"):
        self.device = resolve_device(device)
        self.n = scheme.n
        self.J = scheme.J
        self.T = scheme.T
        self.normalized_load = scheme.normalized_load
        self.design_model = scheme.design_model

    def init_state(self, cells: int) -> SchemeState:
        raise NotImplementedError

    def step(self, state: SchemeState, t: int, stragglers: torch.Tensor) -> SchemeState:
        """Fused assign+observe+collect for round ``t``.

        ``stragglers``: (cells, n) bool, already gate-admitted.  Updates
        ``state`` in place and returns it.
        """
        raise NotImplementedError

    def round_loads(self, state: SchemeState, t: int) -> torch.Tensor:
        """(cells,) per-worker normalized load in round ``t``.

        Constant for every paper scheme; per-cell so load-adaptive
        variants can vary it without touching the engine.
        """
        return torch.full((state.cells,), self.normalized_load, dtype=torch.float64,
                          device=self.device)

    def _zeros(self, *shape, dtype=torch.bool) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _base_arrays(self, cells: int) -> dict:
        return dict(done_round=self._zeros(cells, self.J + 1, dtype=torch.int64),
                    dead=self._zeros(cells))

    def _valid(self, job: int) -> bool:
        """Is ``job`` inside [1, J]?  A host bool: rounds are host ints."""
        return 1 <= job <= self.J

    def _pending(self, state: SchemeState, job: int) -> torch.Tensor:
        """Cells still waiting on ``job``."""
        return (state.done_round[:, job] == 0) & ~state.dead

    def _mark_done(self, state, job: int, can: torch.Tensor, t: int, *, deadline: bool):
        """Record newly decodable cells for ``job``; kill cells that
        missed the deadline when ``deadline`` is set."""
        pending = self._pending(state, job)
        state.done_round[:, job] = torch.where(pending & can, t, state.done_round[:, job])
        if deadline:
            state.dead |= pending & ~can
        return state


class GCKernel(SchemeKernel):
    """Round-wise (n, s)-GC (paper §3.1): job-t decodes from round-t
    survivors or never (T = 0)."""

    name = "gc"

    def __init__(self, scheme, device="cuda"):
        super().__init__(scheme, device)
        self.code = scheme.code

    def init_state(self, cells: int) -> GCState:
        return GCState(**self._base_arrays(cells))

    def step(self, state: GCState, t, stragglers) -> GCState:
        if not self._valid(t):
            return state
        can = self.code.can_decode_mask_batch(~stragglers)
        return self._mark_done(state, t, can, t, deadline=True)


class SRSGCKernel(SchemeKernel):
    """SR-SGC (§3.2, Algorithm 1) with the App.-G Rep refinement
    (Algorithm 3) when the code is a ``RepGradientCode``."""

    name = "sr-sgc"

    def __init__(self, scheme, device="cuda"):
        super().__init__(scheme, device)
        self.B, self.W, self.s = scheme.B, scheme.W, scheme.s
        self.code = scheme.code
        self.rep = scheme._groups is not None
        self.num_groups = scheme.code.num_groups if self.rep else 0

    def init_state(self, cells: int) -> SRSGCState:
        R = self.B + 1
        return SRSGCState(
            returned=self._zeros(cells, R, self.n),
            assigned=self._zeros(cells, R, self.n, dtype=torch.int64),
            n_fresh=self._zeros(cells, R, dtype=torch.int64),
            **self._base_arrays(cells),
        )

    def step(self, state: SRSGCState, t, stragglers) -> SRSGCState:
        n, B = self.n, self.B
        R = B + 1
        cells = state.cells
        tb = t - B
        v_t, v_tb = self._valid(t), self._valid(tb)
        sl_t, sl_b = t % R, tb % R
        if v_t:
            # job-t enters: reclaim its ring slot (held job t-R, whose
            # deadline round t-1 has passed)
            state.returned[:, sl_t] = False
            state.n_fresh[:, sl_t] = 0
        # Algorithm 1 retry rule, vectorized over cells
        jobs = torch.full((cells, n), t, dtype=torch.int64, device=self.device)
        if v_tb:
            prev_ret = state.returned[:, sl_b]
            eligible = ~((state.assigned[:, sl_b] == tb) & prev_ret)
            if self.rep:
                # Algorithm 3: skip workers whose replication group's
                # result is already in (groups are worker-contiguous)
                g = self.s + 1
                covered = prev_ret.reshape(cells, self.num_groups, g).any(dim=2)
                eligible &= ~covered.repeat_interleave(g, dim=1)
            # retries fill eligible workers in worker order until the
            # returned-or-retrying total reaches n - s
            budget = (n - self.s) - state.n_fresh[:, sl_b]
            before = torch.cumsum(eligible, dim=1) - eligible.long()
            jobs = torch.where(eligible & (before < budget[:, None]), tb, jobs)
        state.assigned[:, sl_t] = jobs
        # observe
        ok = ~stragglers
        if v_t:
            mask = ok & (jobs == t)
            state.n_fresh[:, sl_t] = mask.sum(dim=1)
            state.returned[:, sl_t] |= mask
        if v_tb:
            state.returned[:, sl_b] |= ok & (jobs == tb)
        # collect; job t-B hits its Prop-3.1 deadline this round
        for job, valid, dl, slj in ((t, v_t, False, sl_t), (tb, v_tb, True, sl_b)):
            if valid:
                can = self.code.can_decode_mask_batch(state.returned[:, slj])
                state = self._mark_done(state, job, can, t, deadline=dl)
        return state


class MSGCKernel(SchemeKernel):
    """M-SGC (§3.3, Algorithm 2): diagonally interleaved D1/D2 slots.

    The per-job bool masks of the scheduler (``pend``/``d1`` ``[n, W-1]``,
    ``d2`` ``[B, n]``) become job-keyed ring buffers with a cells axis; the
    slot loop stays a Python loop over the ``slots`` diagonal offsets (a
    per-*spec* cost), with every slot update one batched op over all cells.
    """

    name = "m-sgc"

    def __init__(self, scheme, device="cuda"):
        super().__init__(scheme, device)
        self.B, self.W, self.lam = scheme.B, scheme.W, scheme.lam
        self.slots = scheme.slots  # == T + 1: ring size
        self.has_d2 = scheme.lam < scheme.n

    def init_state(self, cells: int) -> MSGCState:
        R, n, W = self.slots, self.n, self.W
        return MSGCState(
            pend=self._zeros(cells, R, n, W - 1),
            d2=self._zeros(cells, R, self.B, n) if self.has_d2 else None,
            **self._base_arrays(cells),
        )

    def step(self, state: MSGCState, t, stragglers) -> MSGCState:
        W, R = self.W, self.slots
        ok = ~stragglers
        if self._valid(t):
            # job-t enters: reclaim its ring slot (job t-R's deadline
            # was round t-1)
            state.pend[:, t % R] = False
            if self.has_d2:
                state.d2[:, t % R] = False
        head_ids = torch.arange(W - 1, device=self.device)[None, None, :]
        for j in range(self.slots):
            job = t - j
            if not self._valid(job):
                continue
            sl = job % R
            if j <= W - 2:
                # first attempt of D1 local chunk j: failures enqueue
                state.pend[:, sl, :, j] |= stragglers
                continue
            # retry the queue head (first pending local chunk) if any,
            # else the group-(j-W+1) coded D2 task: a one-hot on the
            # first set bit clears the head where the retry returned
            pend_j = state.pend[:, sl]
            has = pend_j.any(dim=2)
            head = head_ids == pend_j.to(torch.uint8).argmax(dim=2)[:, :, None]
            state.pend[:, sl] = pend_j & ~((has & ok)[:, :, None] & head)
            if self.has_d2:
                state.d2[:, sl, j - (W - 1)] |= ~has & ok
        # collect every in-flight job (ascending, as the per-cell
        # scheduler does); job t-T hits its Prop-3.2 deadline
        for dj in range(self.T, -1, -1):
            job = t - dj
            if not self._valid(job):
                continue
            sl = job % R
            # D1 complete once all first attempts ran and no failures
            # remain queued; D2 needs n - lam returns in every group
            if dj >= W - 2:
                can = ~state.pend[:, sl].flatten(1).any(dim=1)
                if self.has_d2:
                    can &= (state.d2[:, sl].sum(dim=2) >= self.n - self.lam).all(dim=1)
            else:
                can = self._zeros(state.cells)
            state = self._mark_done(state, job, can, t, deadline=dj == self.T)
        return state


class UncodedKernel(SchemeKernel):
    """Uncoded baseline: tolerates no stragglers (the gate waits every
    candidate out, so admitted straggler sets are empty)."""

    name = "uncoded"

    def init_state(self, cells: int) -> UncodedState:
        return UncodedState(**self._base_arrays(cells))

    def step(self, state: UncodedState, t, stragglers) -> UncodedState:
        if not self._valid(t):
            return state
        return self._mark_done(state, t, ~stragglers.any(dim=1), t, deadline=True)


# ---------------------------------------------------------------------------
# batched wait-out gate
# ---------------------------------------------------------------------------


@dataclass
class GateState:
    """Batched ``ConformanceGate`` state.

    ``bufs[i]``: member-i's rolling suffix window, (cells, w_i - 1, n);
    ``filled`` is a plain int because lockstep commits one row per
    round for every cell; ``alive``: (cells, members) — a member that
    fails once in a cell is dead there forever.  ``history`` collects
    the committed rows ((cells, n) each) for ``effective_pattern``."""

    bufs: list
    alive: torch.Tensor  # (cells, members) bool
    filled: int = 0
    history: list = field(default_factory=list)


class GateKernel:
    """Remark-2.3 wait-out gate over a cells axis (see
    ``straggler.ConformanceGate`` for the single-run semantics it
    reproduces round-for-round).  ``host_syncs`` counts the host checks
    of its data, over all gates (each one waits for the device), as a
    kernel wrapper counts its launches."""

    #: drops retired per greedy iteration between member checks
    CHUNK = 4
    host_syncs = 0

    def __init__(self, model: StragglerModel, n: int, device="cuda"):
        self.device = resolve_device(device)
        self.members = list(model.members) if isinstance(model, MixtureModel) else [model]
        self.windows = [m.window for m in self.members]
        self.n = n
        # every paper model has a closed-form minimal-drop solver and
        # vectorized member checks; the selective wait-out needs them
        self.analytic = all(self._has_solver(m) for m in self.members)
        self.full = max(self.windows)

    @staticmethod
    def _has_solver(m) -> bool:
        if isinstance(m, WindowwiseOr):
            return all(x.min_drops_batch is not None for x in m.members)
        return m.min_drops_batch is not None

    def init_state(self, cells: int) -> GateState:
        return GateState(
            bufs=[torch.zeros((cells, w - 1, self.n), dtype=torch.bool, device=self.device)
                  for w in self.windows],
            alive=torch.ones((cells, len(self.members)), dtype=torch.bool, device=self.device),
        )

    @staticmethod
    def _host_check(flag: torch.Tensor) -> bool:
        GateKernel.host_syncs += 1
        return bool(flag)

    def _tails(self, gs: GateState) -> list:
        """Each member's committed rows inside its window: views of the
        buffers (strided while fewer than ``w - 1`` rows are committed)."""
        return [buf[:, w - 1 - min(gs.filled, w - 1):] for buf, w in zip(gs.bufs, self.windows)]

    def _member_ok(self, tails, alive, cand) -> torch.Tensor:
        """(cells, members): which still-alive members admit ``cand`` as
        each cell's next committed round."""
        cols = []
        for i, (m, tail) in enumerate(zip(self.members, tails)):
            win = torch.cat([tail, cand[:, None]], dim=1) if tail.shape[1] else cand[:, None]
            cols.append(alive[:, i] & m.suffix_ok_batch(win))
        return torch.stack(cols, dim=1)

    def _commit(self, gs: GateState, row: torch.Tensor) -> None:
        for i, w in enumerate(self.windows):
            if w > 1:
                gs.bufs[i] = torch.cat([gs.bufs[i][:, 1:], row[:, None]], dim=1)
        gs.filled = min(gs.filled + 1, self.full)
        gs.history.append(row)

    def admit_partial(self, gs: GateState, candidate, cost, any_cand):
        """Batched selective wait-out (Remark 2.3, refined).

        Per cell: greedily wait out (drop) the cheapest violating workers
        until the remainder is admissible — the scalar gate's loop itself,
        batched: each iteration drops cheapest candidates from EVERY
        unresolved cell at once (``argmin`` breaks cost ties on the first
        index, exactly the scalar rule) and re-checks the members.  Rounds
        where every cell already conforms — the vast majority — cost one
        host check and no iteration.  ``any_cand`` masks cells whose
        candidate set was empty to begin with (their alive flags stay
        untouched, like ``force``).

        Returns ``(gs, effective (cells, n), waited (cells, n))``; commits
        one row for every cell.
        """
        if not self.analytic:
            raise NotImplementedError(
                "the selective wait-out needs gate members with vectorized checks "
                "(min_drops_batch); other models wait for a later slice of the port"
            )
        tails = self._tails(gs)
        # buffer-only statistics (the gate_window buffer kernel) are paid
        # once per round; every greedy iteration is a candidate-only check
        fns = [m.admit_fn_batch(tail) for m, tail in zip(self.members, tails)]

        def member_ok(cand):
            return torch.stack([gs.alive[:, i] & f(cand) for i, f in enumerate(fns)], dim=1)

        mok = member_ok(candidate)
        resolved = mok.any(dim=1)
        cand, waited = candidate, torch.zeros_like(candidate)
        if self._host_check((~resolved & candidate.any(dim=1)).any()):
            cand, waited, mok, resolved = self._wait_out(
                gs, tails, member_ok, candidate, cost, mok, resolved)
        # alive narrows only where a non-empty candidate was admitted;
        # emptied-out cells commit without touching alive (== force)
        gs.alive = torch.where((resolved & any_cand)[:, None], mok, gs.alive)
        self._commit(gs, cand)
        return gs, cand, waited

    def _wait_out(self, gs, tails, member_ok, candidate, cost, mok, resolved):
        """The greedy drops of the rounds that need them: returns
        ``(cand, waited, final member verdicts, resolved)``."""
        n = self.n
        idx = torch.arange(n, device=candidate.device)[None, :]
        # empty-out fast path: admissibility is monotone in the drop
        # prefix, so a row waits out EVERYTHING iff even its last
        # survivor variant — the costliest candidate alone (largest index
        # on cost ties, matching the stable drop order; argmax takes the
        # first maximum of the flipped row) — is inadmissible.  The
        # uncoded gate waits out every candidate every round.
        key = torch.where(candidate, cost, -math.inf)
        wstar = n - 1 - key.flip(dims=(1,)).argmax(dim=1)
        single = candidate & (idx == wstar[:, None])
        empty = ~resolved & candidate.any(dim=1) & ~member_ok(single).any(dim=1)
        waited = candidate & empty[:, None]
        cand = candidate & ~empty[:, None]
        lb_fns = [m.drops_lower_bound_fn_batch(tail, cost)
                  for m, tail in zip(self.members, tails)]
        while self._host_check((~resolved & cand.any(dim=1)).any()):
            active = ~resolved & cand.any(dim=1)
            # rank-free lower bound on the drops still needed: no alive
            # member can admit before ITS bound is gone, and drops proceed
            # in cost order, so the first L cheapest candidates can be
            # retired without re-checking between them (dead members
            # impose no constraint; clamp >= 1 for loop progress)
            bound = None
            for i, lb in enumerate(lb_fns):
                km = torch.where(gs.alive[:, i], lb(cand), n + 1)
                bound = km if bound is None else torch.minimum(bound, km)
            left = torch.where(active, bound.clamp_min(1), 0)
            for j in range(self.CHUNK):
                drop = torch.where(cand, cost, math.inf).argmin(dim=1)
                do = (left > j)[:, None] & (idx == drop[:, None]) & cand
                cand = cand & ~do
                waited = waited | do
            now_ok = member_ok(cand)
            # an emptied-out row commits without a check (alive stays
            # untouched), like the scalar loop's exit path
            newly = active & cand.any(dim=1) & now_ok.any(dim=1)
            mok = torch.where(newly[:, None], now_ok, mok)
            resolved = resolved | newly
        return cand, waited, mok, resolved

    def admit_all(self, gs: GateState, candidate, any_cand):
        """Batched App-J all-or-nothing admission: per cell, admit the
        whole candidate set or wait out every worker (commit zeros).

        Returns ``(gs, effective (cells, n), admitted (cells,))``.
        """
        mok = self._member_ok(self._tails(gs), gs.alive, candidate)
        ok_any = mok.any(dim=1)
        eff = candidate & ok_any[:, None]
        gs.alive = torch.where((ok_any & any_cand)[:, None], mok, gs.alive)
        self._commit(gs, eff)
        return gs, eff, ok_any


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_KERNELS: dict[str, type] = {
    "gc": GCKernel,
    "sr-sgc": SRSGCKernel,
    "m-sgc": MSGCKernel,
    "uncoded": UncodedKernel,
}


def _norm(name: str) -> str:
    """The scheme registry's canonical key, so a kernel registered
    under 'M_SGC' still matches ``Scheme.name == 'm-sgc'``."""
    from .schemes import normalize_scheme_name

    return normalize_scheme_name(name)


def register_kernel(scheme_name: str, kernel_cls: type) -> None:
    """Register a kernel for ``Scheme.name == scheme_name``."""
    _KERNELS[_norm(scheme_name)] = kernel_cls


def has_kernel(scheme_name: str) -> bool:
    return _norm(scheme_name) in _KERNELS


def kernel_seed_sensitive(scheme_name: str) -> bool:
    """Whether the registered kernel declares seed-sensitive stepping
    (the batch engine fans the seed axis out if EITHER the scheme or
    its kernel does)."""
    cls = _KERNELS.get(_norm(scheme_name))
    return bool(getattr(cls, "seed_sensitive", False))


def make_kernel(scheme, device="cuda") -> SchemeKernel:
    """Build the lockstep kernel for a ``Scheme`` prototype on ``device``.

    The prototype supplies all validated static parameters (and the
    gradient code object, whose encode matrix is never built — kernels
    only use capacity/coverage checks)."""
    try:
        cls = _KERNELS[_norm(scheme.name)]
    except KeyError:
        raise KeyError(f"no lockstep kernel registered for scheme {scheme.name!r}") from None
    return cls(scheme, device)
