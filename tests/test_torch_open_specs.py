"""The lockstep engine's open specs against the JAX package's numpy engine.

Three kinds of spec that no paper scheme needs and a user-registered scheme
may (``docs/scheme_kernels.md``):

* a kernel whose ``round_loads`` is load-adaptive: its loads vary per cell
  from its state (each cell's pending jobs), under a scalar and a per-worker
  ``alpha``;
* a selective gate whose members lack the analytic ``min_drops_batch``: a
  per-row model whose admissibility is *not* monotone in the drop prefix
  (no straggler, or 2 to s of them: of 7 candidates at s 5, dropping 2
  admits where dropping 6 does not), alone, inside a ``WindowwiseOr`` and inside a ``MixtureModel``;
  and m-sgc's and sr-sgc's bursty member with its solver taken away;
* a gate member with only the numpy ``suffix_ok`` (the host loop of
  ``StragglerModel.suffix_ok_batch``), in both wait-outs.

Each user scheme, kernel and model is written twice, once against each
package, with the same formulas, and registered in both registries for the
length of a test.  The port runs with ``device="cpu"`` and is held to the
reference's ``simulate_batch`` with ``assert_sim_parity(exact=True)``: bit
for bit, fused and with ``fuse=False``.  Its ``grid_plan`` equals the
reference's on a list that mixes these specs with paper specs.  The
``cuda`` test holds the card's run to the CPU's.
"""

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core import kernel as tk
from repro_torch.core import straggler as tst
from repro_torch.core.schemes import _SCHEME_FACTORIES as T_FACTORIES
from repro_torch.kernels.gate_window import gate_window as gw_kernel
from repro_torch.kernels.gate_window import ref as gw_ref

CPU = "cpu"
N, ROUNDS, TRACES = 12, 14, 3
# about 4.5 stragglers a round at n 12: candidate sets of 3 and more, where
# the non-monotone model's first admissible drop count is not the greedy's
GE = dict(p_ns=0.3, p_sn=0.5, slow_factor=6.0)
S = 5                                            # GC's s, the model's limit
MSGC = {"B": 2, "W": 3, "lam": 5}
SRSGC = {"B": 1, "W": 3, "lam": 5, "prefer_rep": False}
# alpha stays small: a large one lifts every time and empties candidate sets
ALPHA = 1.0
ALPHAS = {"scalar": ALPHA, "per-worker": ALPHA * (0.5 + np.random.default_rng(5).random(N))}
WAITOUTS = ["selective", "all"]


def _traces(num=TRACES, rounds=ROUNDS, seed0=40):
    return np.stack([tst.GilbertElliotSource(n=N, seed=seed0 + k, **GE).sample_delays(rounds)
                     for k in range(num)])


# -- the user's models, kernels and schemes, in each package ---------------------------


def _admits(c, s):
    """A row's verdict: no straggler, or 2 to ``s`` of them (numpy or torch)."""
    return (c == 0) | ((c >= 2) & (c <= s))


def _models(base, bursty, vectorized):
    """(host-only model, vectorized model, bursty without its solver) built
    on ``base`` (either package's ``StragglerModel``) and ``bursty`` (its
    ``BurstyModel``); ``vectorized(win, s)`` is the package's one-pass check."""

    class HostOnly(base):
        """Every row: no straggler, or 2 to s; only the numpy check."""

        def __init__(self, s):
            self.s = s

        def conforms(self, pattern):
            return bool(_admits(np.asarray(pattern).sum(axis=1), self.s).all())

        @property
        def window(self):
            return 1

    class NonMonotone(HostOnly):
        def suffix_ok_batch(self, win):
            return vectorized(win, self.s)

    class NoSolverBursty(bursty):
        min_drops_batch = None

    return HostOnly, NonMonotone, NoSolverBursty


def _port_models():
    return _models(tst.StragglerModel, tst.BurstyModel,
                   lambda win, s: _admits(win.sum(dim=2), s).all(dim=1))


def _ref_models():
    from repro.core import straggler as rst

    return _models(rst.StragglerModel, rst.BurstyModel,
                   lambda win, s: _admits(win.sum(axis=2), s).all(axis=1))


def _adaptive_kernel(base, to_f64):
    """An M-SGC kernel whose load grows with each cell's pending jobs (jobs
    before round t not yet decodable): ``load * (1 + 0.25 * pending)``."""

    class Adaptive(base):
        name = "m-sgc-adaptive"

        def round_loads(self, state, t):
            pending = to_f64((state.done_round[:, 1:t] == 0).sum(1))
            return self.normalized_load * (1.0 + 0.25 * pending)

    return Adaptive


def _factories(pkg, mods):
    """The user schemes of one package: name -> factory."""
    HostOnly, NonMonotone, NoSolverBursty = mods
    st = pkg.straggler

    def gc(name, model):
        def make(n, J, seed=0, **kw):
            sch = pkg.make_scheme("gc", n, J, s=S, prefer_rep=False, seed=seed)
            sch.name, sch.design_model = name, model
            return sch
        return make

    def renamed(base, name, params, design=None):
        def make(n, J, seed=0, **kw):
            sch = pkg.make_scheme(base, n, J, seed=seed, **params)
            sch.name = name
            if design is not None:
                sch.design_model = design(sch)
            return sch
        return make

    return {
        "nm-gc": gc("nm-gc", NonMonotone(S)),
        "nm-or-gc": gc("nm-or-gc", st.WindowwiseOr((NonMonotone(S), st.PerRoundModel(1)), 3)),
        "nm-mix-gc": gc("nm-mix-gc", st.MixtureModel((NonMonotone(S), st.PerRoundModel(1)))),
        "host-gc": gc("host-gc", HostOnly(S)),
        "m-sgc-nosolver": renamed("m-sgc", "m-sgc-nosolver", MSGC, lambda sch: st.MixtureModel(
            (NoSolverBursty(*MSGC.values()), sch.design_model.members[1]))),
        "sr-sgc-nosolver": renamed(
            "sr-sgc", "sr-sgc-nosolver", SRSGC, lambda sch: st.WindowwiseOr(
                (NoSolverBursty(SRSGC["B"], SRSGC["W"], SRSGC["lam"]),
                 sch.design_model.members[1]), SRSGC["W"])),
        "m-sgc-adaptive": renamed("m-sgc", "m-sgc-adaptive", MSGC),
    }


KERNELS = {"nm-gc": "GCKernel", "nm-or-gc": "GCKernel", "nm-mix-gc": "GCKernel",
           "host-gc": "GCKernel", "m-sgc-nosolver": "MSGCKernel",
           "sr-sgc-nosolver": "SRSGCKernel", "m-sgc-adaptive": None}


@pytest.fixture(scope="module")
def rc():
    """The JAX package's ``repro.core`` (its numpy engine and planner)."""
    import repro.core

    return repro.core


@pytest.fixture
def port_specs():
    """Registers every user scheme and kernel in the port; removes them after
    the test."""
    port = _factories(tc, _port_models())
    for name, kern in KERNELS.items():
        tc.register_scheme(name, port[name])
        tk.register_kernel(name, getattr(tk, kern) if kern else _adaptive_kernel(
            tk.MSGCKernel, lambda x: x.to(torch.float64)))
    yield
    for name in KERNELS:
        T_FACTORIES.pop(name, None)
        tk._KERNELS.pop(name, None)


@pytest.fixture
def user_specs(rc, port_specs):
    """The same in both packages."""
    from repro.core import kernel as rk
    from repro.core.schemes import _SCHEME_FACTORIES as R_FACTORIES

    ref = _factories(rc, _ref_models())
    for name, kern in KERNELS.items():
        rc.register_scheme(name, ref[name])
        rk.register_kernel(name, getattr(rk, kern) if kern else _adaptive_kernel(
            rk.MSGCKernel, lambda x: x.astype(np.float64)))
    yield
    for name in KERNELS:
        R_FACTORIES.pop(name, None)
        rk._KERNELS.pop(name, None)


@pytest.fixture(scope="module")
def parity():
    from repro.core.testing import assert_sim_parity

    return assert_sim_parity


def _check(rc, parity, specs, traces, *, alive=True, **kw):
    """The port's simulate_batch, fused and not, against the reference's:
    bit for bit in every cell; ``alive`` demands every cell finish."""
    want = rc.simulate_batch(specs, traces, strict=False, **kw)
    for fuse in (True, False):
        got = tc.simulate_batch(specs, traces, strict=False, device=CPU, fuse=fuse, **kw)
        assert got.shape == want.shape
        for w, g in zip(want.ravel(), got.ravel()):
            assert (w is None) == (g is None)
            if w is not None:
                parity(w, g, exact=True)
    if alive:
        assert all(r is not None for r in want.ravel())
    return want


# -- load-adaptive loads ------------------------------------------------------------------


@pytest.mark.parametrize("waitout", WAITOUTS)
@pytest.mark.parametrize("alpha", list(ALPHAS))
def test_load_adaptive_kernel_matches_the_reference(rc, parity, user_specs, alpha, waitout):
    """Per-cell loads from each cell's pending jobs, read before the round's
    step: the same round times, patterns and done rounds as the reference's
    per-round branch, bit for bit; and not M-SGC's constant-load times."""
    traces = _traces()
    want = _check(rc, parity, [("m-sgc-adaptive", {})], traces, alpha=ALPHAS[alpha],
                  waitout=waitout)
    const = tc.simulate_batch([("m-sgc", MSGC)], traces, alpha=ALPHAS[alpha],
                              waitout=waitout, device=CPU)
    assert any((w.round_times != c.round_times).any()
               for w, c in zip(want.ravel(), const.ravel()))
    # the pending jobs differ between cells, so do the loads a round
    kern = tc.make_kernel(tc.make_scheme("m-sgc-adaptive", N, 10), CPU)
    state = kern.init_state(2)
    state.done_round[0, 1:4] = 2
    assert kern.round_loads(state, 5).unique().numel() == 2


# -- gates that are not analytic --------------------------------------------------------


GATES = ["nm-gc", "nm-or-gc", "nm-mix-gc", "m-sgc-nosolver", "sr-sgc-nosolver"]


@pytest.mark.parametrize("waitout", WAITOUTS)
@pytest.mark.parametrize("name", GATES)
def test_non_analytic_gate_matches_the_reference(rc, parity, user_specs, name, waitout):
    """Every drop count's variant checked, the first admissible one taken:
    the reference's numpy branch, bit for bit, in both wait-outs; the gate
    is not analytic and the selective runs wait something out."""
    traces = _traces(seed0=50)
    gate = tk.GateKernel(tc.make_scheme(name, N, 8).design_model, N, CPU)
    assert not gate.analytic
    want = _check(rc, parity, [(name, {})], traces, alpha=ALPHA, waitout=waitout)
    assert sum(r.waitouts for r in want.ravel()) > 0


def test_gate_takes_the_first_admissible_drop_count_not_the_greedy_shortcuts(rc, user_specs):
    """One round of the gate alone against the reference's, on candidate sets
    of 1 to 7 at n 12: under "none, or 2 to 5" a set of 7 drops its 2
    cheapest, one of 6 its cheapest, one of 1 waits out.  The greedy loop's
    empty-out shortcut (the costliest candidate alone is inadmissible, so it
    would wait out every set) and its lower-bound chunks assume monotone
    admissibility; the variant check does not."""
    from repro.core import kernel as rk
    from repro.core.backend import get_backend

    rng = np.random.default_rng(3)
    cells = 7
    cand = np.zeros((cells, N), dtype=bool)
    for c in range(cells):
        cand[c, rng.choice(N, c + 1, replace=False)] = True
    cost = rng.random((cells, N))
    any_cand = cand.any(axis=1)
    for name in ("nm-gc", "nm-or-gc", "nm-mix-gc"):
        ref_model = rc.make_scheme(name, N, 4).design_model
        model = tc.make_scheme(name, N, 4).design_model
        rgate = rk.GateKernel(ref_model, N, get_backend("numpy"))
        gate = tk.GateKernel(model, N, CPU)
        rgs, gs = rgate.init_state(cells), gate.init_state(cells)
        for _ in range(2):   # a second round over a committed buffer row
            rgs, reff, rwait = rgate.admit_partial(rgs, cand, cost, any_cand)
            gs, eff, wait = gate.admit_partial(gs, torch.from_numpy(cand), torch.from_numpy(cost),
                                               torch.from_numpy(any_cand))
            np.testing.assert_array_equal(eff.numpy(), reff)
            np.testing.assert_array_equal(wait.numpy(), rwait)
            np.testing.assert_array_equal(gs.alive.numpy(), rgs.alive)
        kept = eff.sum(dim=1).tolist()
        if name == "nm-gc":
            assert kept == [0, 2, 3, 4, 5, 5, 5]
            # the 2 cheapest of the 7 went
            dropped = np.flatnonzero(wait[6].numpy())
            assert sorted(dropped) == sorted(np.argsort(np.where(cand[6], cost[6], np.inf))[:2])


# -- a member with only the numpy suffix_ok -----------------------------------------------


@pytest.mark.parametrize("waitout", WAITOUTS)
def test_host_only_model_matches_the_reference(rc, parity, user_specs, waitout):
    """The host loop of ``suffix_ok_batch`` (one read of the window a call,
    counted in ``StragglerModel.host_reads``) gives the reference's cells."""
    traces = _traces(seed0=60)
    tst.StragglerModel.host_reads = 0
    _check(rc, parity, [("host-gc", {})], traces, alpha=ALPHA, waitout=waitout)
    assert tst.StragglerModel.host_reads > 0
    # a card tensor's window comes back on its own device
    model = tc.make_scheme("host-gc", N, 4).design_model
    win = torch.zeros((3, 1, N), dtype=torch.bool)
    win[1, 0, :1] = True
    got = model.suffix_ok_batch(win)
    assert got.tolist() == [True, False, True] and got.device == win.device


# -- mixed lists --------------------------------------------------------------------------


MIXED = [("m-sgc-adaptive", {}), ("nm-gc", {}), ("m-sgc", MSGC), ("host-gc", {}),
         ("m-sgc", {**MSGC, "lam": 4}), ("m-sgc-nosolver", {}), ("gc", {"s": 3}),
         ("sr-sgc-nosolver", {}), ("nm-mix-gc", {})]


@pytest.mark.parametrize("waitout", WAITOUTS)
def test_grid_plan_matches_the_reference_on_a_mixed_list(rc, user_specs, waitout):
    """The open specs beside paper specs: the same buckets, fallbacks and
    infeasible specs as the reference's planner (load-adaptive loads always,
    and in the selective wait-out the gates that are not analytic, go to
    the per-spec path)."""
    traces = _traces()
    plan = tc.grid_plan(MIXED, traces, waitout=waitout)
    assert plan == rc.grid_plan(MIXED, traces, waitout=waitout)
    assert plan["fallback"] == ([0, 1, 3, 5, 7, 8] if waitout == "selective" else [0])


@pytest.mark.parametrize("waitout", WAITOUTS)
def test_mixed_list_matches_the_reference_fused_and_per_spec(rc, parity, user_specs, waitout):
    """The whole mixed list through ``simulate_batch``: fused = ``fuse=False``
    = the reference's numpy engine, bit for bit, with the per-worker alpha."""
    _check(rc, parity, MIXED, _traces(seed0=70), alpha=ALPHAS["per-worker"], waitout=waitout,
           alive=False)


# -- on the card --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: pytest -m cuda)")
    return torch.device("cuda", 0)


def _device_parity(want, got, exact):
    """The simulator's device contract: exact bookkeeping, allclose times
    (bit for bit where ``exact``)."""
    assert want.job_done_round == got.job_done_round and want.waitouts == got.waitouts
    assert (want.effective_pattern == got.effective_pattern).all()
    if exact:
        assert (want.round_times == got.round_times).all()
        assert want.job_done_time == got.job_done_time
    else:
        assert np.allclose(want.round_times, got.round_times)


@pytest.mark.cuda
def test_open_specs_on_the_card_match_the_cpu(cuda_device, port_specs):
    """The mixed list on the card (fused and not) against the CPU's run under
    the device contract, gate-window launches = the CPU's plain calls."""
    traces = _traces(seed0=80)
    for waitout in WAITOUTS:
        gw_kernel.window_stats.launches = gw_kernel.buffer_stats.launches = 0
        got = tc.simulate_batch(MIXED, traces, alpha=ALPHA, waitout=waitout, strict=False,
                                device=cuda_device)
        launched = (gw_kernel.window_stats.launches, gw_kernel.buffer_stats.launches)
        gw_ref.window_stats.calls = gw_ref.buffer_stats.calls = 0
        want = tc.simulate_batch(MIXED, traces, alpha=ALPHA, waitout=waitout, strict=False,
                                 device=CPU)
        assert launched == (gw_ref.window_stats.calls, gw_ref.buffer_stats.calls)
        per_spec = tc.simulate_batch(MIXED, traces, alpha=ALPHA, waitout=waitout, strict=False,
                                     device=cuda_device, fuse=False)
        for w, g, p in zip(want.ravel(), got.ravel(), per_spec.ravel()):
            assert (w is None) == (g is None) == (p is None)
            if w is not None:
                _device_parity(w, g, exact=False)
                _device_parity(p, g, exact=True)
