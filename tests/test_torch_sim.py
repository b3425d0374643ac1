"""The port's simulator (``repro_torch.core`` kernel / batch / simulator)
against the JAX package's.

The reference's staged JAX engine does not run on the installed JAX, so the
port's lockstep engine is held to the reference's **numpy** engine with the
reference's own device contract, ``assert_sim_parity(exact=False)``: exact on
done rounds, wait-outs and effective patterns, allclose on the float times.
On the CPU the port also agrees bit for bit, which the tests check as well.
The descriptor-path ``simulate`` and the scalar ``simulate_fast`` are held to
the reference's bit for bit.  Everything here runs with ``device="cpu"``; the
``cuda``-marked tests hold the card's run to the CPU's.
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

GE = dict(p_ns=0.08, p_sn=0.6, slow_factor=6.0)   # tests/test_lockstep.py
CPU = "cpu"

# tests/test_lockstep.py's CONFIGS without the clustered baselines
CONFIGS = [
    ("gc", dict(s=3)),                     # 4 | 12 -> GC-Rep
    ("gc", dict(s=3, prefer_rep=False)),   # general code
    ("gc", dict(s=4)),                     # 5 does not divide 12 -> general
    ("sr-sgc", dict(B=1, W=2, lam=3)),
    ("sr-sgc", dict(B=2, W=3, lam=5)),
    ("sr-sgc", dict(B=1, W=4, lam=4)),     # multi-row buffers inside WindowwiseOr
    ("m-sgc", dict(B=1, W=2, lam=3)),
    ("m-sgc", dict(B=2, W=3, lam=5)),
    ("m-sgc", dict(B=1, W=3, lam=12)),     # lam == n (Remark 3.2, no D2)
    ("uncoded", {}),
]
IDS = [f"{n}-{i}" for i, (n, _) in enumerate(CONFIGS)]


@pytest.fixture(scope="module")
def rc():
    """The JAX package's ``repro.core`` (its numpy engine)."""
    import repro.core

    return repro.core


@pytest.fixture(scope="module")
def parity():
    from repro.core.testing import assert_sim_parity

    return assert_sim_parity


def _traces(n, rounds, num, seed0=0, **ge):
    return np.stack([
        tst.GilbertElliotSource(n=n, seed=seed0 + k, **(ge or GE)).sample_delays(rounds)
        for k in range(num)
    ])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the models' tensor hooks ----------------------------------------------------


def _model_pairs(n):
    from repro.core import straggler as rst

    return {
        "per-round": (rst.PerRoundModel(2), tst.PerRoundModel(2)),
        "per-round-0": (rst.PerRoundModel(0), tst.PerRoundModel(0)),
        "bursty": (rst.BurstyModel(2, 4, 3), tst.BurstyModel(2, 4, 3)),
        "bursty-b1": (rst.BurstyModel(1, 3, 2), tst.BurstyModel(1, 3, 2)),
        "arbitrary": (rst.ArbitraryModel(2, 4, 3), tst.ArbitraryModel(2, 4, 3)),
        "arbitrary-n0": (rst.ArbitraryModel(0, 3, 4), tst.ArbitraryModel(0, 3, 4)),
        "rep-coverage": (rst.RepCoverageModel(n, 1), tst.RepCoverageModel(n, 1)),
        "windowwise-or": (
            rst.WindowwiseOr((rst.BurstyModel(1, 4, 3), rst.PerRoundModel(1)), 4),
            tst.WindowwiseOr((tst.BurstyModel(1, 4, 3), tst.PerRoundModel(1)), 4)),
    }


@pytest.mark.parametrize("label", list(_model_pairs(8)))
def test_tensor_hooks_equal_the_reference(label):
    """suffix_ok_batch, min_drops_batch, admit_fn_batch and
    drops_lower_bound_fn_batch on torch tensors == the reference's numpy
    hooks, for every committed-buffer depth of the model's window."""
    n, cells = 8, 64
    want, got = _model_pairs(n)[label]
    rng = np.random.default_rng(sum(map(ord, label)))
    for kh in range(want.window):
        buf = rng.random((cells, kh, n)) < 0.15
        cand = rng.random((cells, n)) < 0.3
        cost = rng.integers(1, 5, (cells, n)).astype(np.float64)  # ties break on index
        order = np.argsort(np.where(cand, cost, np.inf), axis=1, kind="stable")
        rank = np.empty_like(order)
        np.put_along_axis(rank, order, np.arange(n)[None, :], axis=1)
        win = np.concatenate([buf, cand[:, None]], axis=1)
        pairs = [
            (want.suffix_ok_batch(win), got.suffix_ok_batch(_t(win))),
            (want.min_drops_batch(buf, cand, rank, order),
             got.min_drops_batch(_t(buf), _t(cand), _t(rank), _t(order))),
            (want.admit_fn_batch(buf)(cand), got.admit_fn_batch(_t(buf))(_t(cand))),
            (want.drops_lower_bound_fn_batch(buf, cost)(cand),
             got.drops_lower_bound_fn_batch(_t(buf), _t(cost))(_t(cand))),
        ]
        for w, g in pairs:
            assert isinstance(g, torch.Tensor) and g.shape == (cells,)
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{label} kh={kh}")


@pytest.mark.parametrize("n,s,prefer_rep", [(12, 3, True), (12, 3, False), (12, 4, True)])
def test_can_decode_mask_batch_on_tensors(rc, n, s, prefer_rep):
    want = rc.make_gradient_code(n, s, prefer_rep=prefer_rep)
    got = tc.make_gradient_code(n, s, prefer_rep=prefer_rep)
    surv = np.random.default_rng(n + s).random((5, 7, n)) < 0.7
    np.testing.assert_array_equal(got.can_decode_mask_batch(_t(surv)).numpy(),
                                  want.can_decode_mask_batch(surv))


# -- scalar paths: bit for bit ----------------------------------------------------


@pytest.mark.parametrize("name,kw", CONFIGS, ids=IDS)
@pytest.mark.parametrize("waitout", ["selective", "all"])
def test_simulate_and_simulate_fast_equal_the_reference(rc, parity, name, kw, waitout):
    n, J = 12, 20
    delays = _traces(n, 26, 1, seed0=20)[0]
    for sim_t, sim_r in ((tc.simulate, rc.simulate), (tc.simulate_fast, rc.simulate_fast)):
        got = sim_t(tc.make_scheme(name, n, J, **kw), delays, alpha=6.0, J=J, waitout=waitout)
        want = sim_r(rc.make_scheme(name, n, J, **kw), delays, alpha=6.0, J=J, waitout=waitout)
        parity(want, got, exact=True)


# -- the lockstep engine against the reference's numpy engine ----------------------


@pytest.mark.parametrize("name,kw", CONFIGS, ids=IDS)
@pytest.mark.parametrize("waitout", ["selective", "all"])
def test_lockstep_matches_the_numpy_engine(rc, parity, name, kw, waitout):
    n, J, cells = 12, 20, 3
    traces = _traces(n, 26, cells, seed0=20)
    want = rc.simulate_lockstep(name, kw, traces, alpha=6.0, J=J, waitout=waitout)
    got = tc.simulate_lockstep(name, kw, traces, alpha=6.0, J=J, waitout=waitout, device=CPU)
    assert len(got) == cells
    for w, g in zip(want, got):
        parity(w, g, exact=False)   # the device contract
        parity(w, g, exact=True)    # and, on the CPU, bit for bit


def test_lockstep_takes_a_per_worker_alpha(rc, parity):
    n = 12
    traces = _traces(n, 24, 2, seed0=33)
    alpha = np.linspace(2.0, 9.0, n)
    for name, kw in (("m-sgc", dict(B=2, W=3, lam=5)), ("sr-sgc", dict(B=1, W=4, lam=4))):
        want = rc.simulate_lockstep(name, kw, traces, alpha=alpha)
        got = tc.simulate_lockstep(name, kw, traces, alpha=alpha, device=CPU)
        for w, g in zip(want, got):
            parity(w, g, exact=False)


@pytest.mark.parametrize("waitout", ["selective", "all"])
def test_ragged_grid_mixed_specs(rc, parity, waitout):
    """simulate_batch over specs with different T/J: every cell equals the
    reference's scalar run with that spec's fitted J."""
    n, rounds = 12, 22
    specs = [("gc", {"s": 3}), ("sr-sgc", {"B": 2, "W": 3, "lam": 5}),
             ("m-sgc", {"B": 2, "W": 3, "lam": 5}), ("uncoded", {})]
    traces = _traces(n, rounds, 2, seed0=40)
    grid = tc.simulate_batch(specs, traces, alpha=6.0, waitout=waitout, device=CPU)
    assert grid.shape == (len(specs), 1, 2)
    for i, (name, params) in enumerate(specs):
        J = rounds - tc.make_scheme(name, n, 1, **params).T
        for c in range(2):
            assert grid[i, 0, c].rounds == rounds
            want = rc.simulate_fast(rc.make_scheme(name, n, J, **params), traces[c],
                                    alpha=6.0, J=J, waitout=waitout)
            parity(want, grid[i, 0, c], exact=False)


# port copies of the reference's registered fixtures (repro/core/testing.py)


class FragileGCScheme(tc.GCScheme):
    """General-code GC whose design model admits up to ``d`` stragglers per
    round while only ``s`` decode: admitted rounds with more than ``s``
    stragglers kill their cell."""

    name = "fragile-gc"

    def __init__(self, n, J, *, s=1, d=None, seed=0):
        super().__init__(n, s, J, prefer_rep=False, seed=seed)
        self.d = s if d is None else d
        self.design_model = tst.PerRoundModel(self.d)


class SeededUncodedScheme(tc.NoCodingScheme):
    """Uncoded baseline whose normalized load depends on the seed."""

    name = "seeded-uncoded"
    seed_sensitive = True

    def __init__(self, n, J, *, seed=0):
        super().__init__(n, J)
        self.seed = seed
        self.normalized_load = (1.0 + 0.5 * (seed % 3)) / n


class SeededUncodedKernel(tk.UncodedKernel):
    name = "seeded-uncoded"
    seed_sensitive = True


class FragileGCKernel(tk.GCKernel):
    name = "fragile-gc"


@pytest.fixture
def fixtures(rc):
    """Both packages' fixture schemes, registered for one test."""
    from repro.core import testing as rt

    rt.register_testing_schemes()
    rt.register_fragile_gc()
    tc.register_scheme("fragile-gc", lambda n, J, **kw: FragileGCScheme(n, J, **kw))
    tc.register_kernel("fragile-gc", FragileGCKernel)
    tc.register_scheme("seeded-uncoded", lambda n, J, **kw: SeededUncodedScheme(n, J, **kw))
    tc.register_kernel("seeded-uncoded", SeededUncodedKernel)
    tc.register_scheme("seeded-uncoded-nokernel",
                       lambda n, J, **kw: SeededUncodedScheme(n, J, **kw))
    yield rt
    rt.unregister_testing_schemes()
    rt.unregister_fragile_gc()
    for name in ("fragile-gc", "seeded-uncoded", "seeded-uncoded-nokernel"):
        T_FACTORIES.pop(name, None)
        tk._KERNELS.pop(name, None)


def test_strict_false_infeasible_and_dead_cells(rc, parity, fixtures):
    """Infeasible specs give None rows; cells of a fragile spec that admit
    more stragglers than decode die (None) while their neighbours equal the
    reference; strict=True raises."""
    n = 12
    traces = _traces(n, 16, 4, seed0=60, p_ns=0.05, p_sn=0.6, slow_factor=6.0)
    specs = [("sr-sgc", {"B": 2, "W": 4, "lam": 3}),   # B does not divide W-1
             ("gc", {"s": 3}),
             ("m-sgc", {"B": 3, "W": 2, "lam": 2}),    # needs B < W
             ("fragile-gc", {"s": 1, "d": 2})]
    for waitout in ("selective", "all"):
        got = tc.simulate_batch(specs, traces, alpha=6.0, strict=False, waitout=waitout,
                                device=CPU)
        want = rc.simulate_batch(specs, traces, alpha=6.0, strict=False, waitout=waitout)
        assert all(r is None for r in got[0].ravel()) and all(r is None for r in got[2].ravel())
        dead = [g is None for g in got[3, 0]]
        assert any(dead) and not all(dead)
        for si in (1, 3):
            for w, g in zip(want[si, 0], got[si, 0]):
                assert (w is None) == (g is None)
                if g is not None:
                    parity(w, g, exact=False)
    with pytest.raises(ValueError):
        tc.simulate_batch(specs, traces, alpha=6.0, device=CPU)
    with pytest.raises(AssertionError, match="wait-out contract"):
        tc.simulate_lockstep("fragile-gc", {"s": 1, "d": 2}, traces, alpha=6.0, device=CPU)


def test_seed_axis_fans_out_or_is_shared(rc, parity, fixtures):
    n, num = 12, 3
    seeds = (0, 1, 2, 5)
    traces = _traces(n, 12, num, seed0=95)
    specs = [("seeded-uncoded", {}), ("seeded-uncoded-nokernel", {}), ("gc", {"s": 3})]
    grid = tc.simulate_batch(specs, traces, seeds=seeds, alpha=6.0, device=CPU)
    assert grid.shape == (3, len(seeds), num)
    for si in (0, 1):  # through the lockstep kernel, and the kernel-less host route
        for ki, seed in enumerate(seeds):
            for ti in range(num):
                r = grid[si, ki, ti]
                assert r.normalized_load == (1.0 + 0.5 * (seed % 3)) / n
                want = rc.simulate_fast(fixtures.SeededUncodedScheme(n, 12, seed=seed),
                                        traces[ti], alpha=6.0, J=12)
                parity(want, r, exact=False)
        assert grid[si, 0, 0] is not grid[si, 1, 0]
        assert grid[si, 0, 0].total_time != grid[si, 1, 0].total_time
    for ki in range(1, len(seeds)):
        for ti in range(num):
            assert grid[2, ki, ti] is grid[2, 0, ti]


def test_dead_worker_trace(rc, parity):
    """A worker dead from round 4 on is an always-straggler row that the
    per-round gates admit, and every job still decodes."""
    from repro.core.testing import dead_worker_delays

    n, J, r_die, w = 8, 10, 4, 2
    base = tst.GilbertElliotSource(n=n, seed=9, p_ns=0.15, p_sn=0.5, slow_factor=5.0,
                                   jitter=0.05).sample_delays(J + 4)
    traces = dead_worker_delays(base, w, r_die)[None]
    for name, kw in [("gc", {"s": 2}), ("gc", {"s": 3, "prefer_rep": False})]:
        want = rc.simulate_fast(rc.make_scheme(name, n, J, **kw), traces[0], alpha=6.0, J=J)
        got = tc.simulate_lockstep(name, kw, traces, alpha=6.0, J=J, device=CPU)[0]
        parity(want, got, exact=False)
        assert got.effective_pattern[r_die - 1:, w].all()
        assert sorted(got.job_done_round) == list(range(1, J + 1))


def test_gate_kernel_windowwise_or_buffer_violation():
    """Inside a WindowwiseOr, committed rows may violate one arm (the window
    was admitted through another): the gate must not credit that arm
    (tests/test_lockstep.py's regression, on the port's gate)."""
    n = 6
    model = tst.WindowwiseOr((tst.BurstyModel(2, 4, 4), tst.PerRoundModel(2)), 4)
    # worker 0 straggles twice, 2 >= B rounds apart: each row is
    # PerRound-admissible but the Bursty arm can never admit the window
    rows = [np.eye(1, n, 0, dtype=bool)[0], np.zeros(n, bool), np.eye(1, n, 0, dtype=bool)[0]]
    cand = np.array([0, 1, 1, 1, 0, 0], dtype=bool)
    cost = np.arange(n, dtype=float) + 1.0

    scalar = tst.ConformanceGate(model, n)
    for r in rows:
        assert scalar.admit(r.copy())
    eff_s, waited_s = scalar.admit_partial(cand.copy(), cost)

    gk = tk.GateKernel(model, n, CPU)
    gs = gk.init_state(1)
    for r in rows:
        gs, eff, _ = gk.admit_partial(gs, _t(r[None]), _t(cost[None]),
                                      torch.tensor([bool(r.any())]))
        assert (eff[0].numpy() == r).all()
    gs, eff_b, waited_b = gk.admit_partial(gs, _t(cand[None]), _t(cost[None]),
                                           torch.tensor([True]))
    assert (eff_b[0].numpy() == eff_s).all()
    assert sorted(np.flatnonzero(waited_b[0].numpy()).tolist()) == sorted(waited_s)


def test_gate_runs_the_window_statistics_once_per_round_and_check():
    """The selective gate calls buffer_stats per member and round; the
    all-or-nothing gate calls window_stats; both count their host checks."""
    n = 12
    traces = _traces(n, 20, 3, seed0=7)
    before = (gw_ref.window_stats.calls, gw_ref.buffer_stats.calls, tk.GateKernel.host_syncs)
    tc.simulate_lockstep("m-sgc", dict(B=2, W=3, lam=5), traces, alpha=6.0, device=CPU)
    mid = (gw_ref.window_stats.calls, gw_ref.buffer_stats.calls, tk.GateKernel.host_syncs)
    assert mid[0] == before[0] and mid[1] > before[1]
    assert mid[2] - before[2] >= 20   # one check per round, at least
    tc.simulate_lockstep("m-sgc", dict(B=2, W=3, lam=5), traces, alpha=6.0, waitout="all",
                         device=CPU)
    after = (gw_ref.window_stats.calls, gw_ref.buffer_stats.calls, tk.GateKernel.host_syncs)
    assert after[0] == mid[0] + 2 * 20 and after[1:] == mid[1:]


# -- selection and the adaptive trainer --------------------------------------------


@pytest.mark.parametrize("name,grid", [
    ("gc", [{"s": s} for s in (1, 2, 3, 4, 6)]),
    ("sr-sgc", [{"B": B, "W": B + 1, "lam": lam} for B in (1, 2) for lam in (2, 4, 6)]
     + [{"B": 2, "W": 4, "lam": 3}]),   # infeasible: B does not divide W-1
    ("m-sgc", [{"B": B, "W": W, "lam": lam} for B, W in ((1, 2), (2, 3), (1, 3))
               for lam in (0, 2, 5, 12)]),
    ("gc", None),   # the default grid
])
def test_select_parameters_matches_the_reference(rc, name, grid):
    n = 12
    probe = tst.GilbertElliotSource(n=n, seed=4, p_ns=0.1, p_sn=0.5,
                                    slow_factor=6.0).sample_delays(24)
    want = rc.select_parameters(name, n, probe, alpha=6.0, grid=grid)
    for got in (tc.select_parameters(name, n, probe, alpha=6.0, grid=grid, device=CPU),
                tc.select_parameters_legacy(name, n, probe, alpha=6.0, grid=grid)):
        assert (got.name, got.params, got.load) == (want.name, want.params, want.load)
        assert np.isclose(got.est_time, want.est_time)


def test_default_grid_and_params_delay_equal_the_reference(rc):
    from repro.core import simulator as rsim

    for name in ("gc", "sr-sgc", "m-sgc", "uncoded"):
        assert tc.default_grid(name, 16) == rsim.default_grid(name, 16)
        for params in tc.default_grid(name, 16):
            assert tc.params_delay(name, params) == rsim.params_delay(name, params)
    assert tc.estimate_alpha(12) == rc.estimate_alpha(12)
    np.testing.assert_array_equal(tc.reference_profile(8, 10, seed=2),
                                  rsim.reference_profile(8, 10, seed=2))
    assert not tc.has_kernel("dc-gc") and not tc.has_kernel("sb-gc")


def test_run_adaptive_matches_the_reference():
    """Probe uncoded, select on the lockstep engine, train coded: the same
    selected parameters and the same simulated clocks as the JAX package."""
    import repro.core as rcore
    from repro.train import run_adaptive as ref_run_adaptive

    from repro_torch.train import run_adaptive

    n, J, t_probe = 8, 14, 6
    delays = rcore.GilbertElliotSource(n=n, p_ns=0.1, p_sn=0.6, slow_factor=6.0,
                                       seed=3).sample_delays(J + 6)
    grid = [{"B": B, "W": B + 1, "lam": lam} for B in (1, 2) for lam in (1, 2, 3)]
    want = ref_run_adaptive(4, J, delays, t_probe=t_probe, batch_size=64, grid=grid)
    got = run_adaptive(4, J, delays, t_probe=t_probe, batch_size=64, grid=grid, device=CPU)
    assert got[2] == want[2]
    assert got[0] == want[0] and got[1] == want[1]
    assert sorted(got[3].job_done_time) == list(range(1, J - t_probe + 1))
    assert all(np.isfinite(got[3].losses[m]).all() for m in range(4))


# -- what the engine refuses ---------------------------------------------------------


class _LoadAdaptiveScheme(tc.NoCodingScheme):
    name = "load-adaptive"


class _LoadAdaptiveKernel(tk.UncodedKernel):
    name = "load-adaptive"

    def round_loads(self, state, t):
        return super().round_loads(state, t) * (1 + t % 2)


class _HostOnlyModel(tst.StragglerModel):
    """A per-round model without the vectorized solvers."""

    def conforms(self, pattern):
        return bool((pattern.sum(axis=1) <= 1).all())

    @property
    def window(self):
        return 1


def test_unstageable_specs_raise(monkeypatch):
    n = 8
    traces = _traces(n, 10, 2, seed0=3)
    tc.register_scheme("load-adaptive", lambda n, J, **kw: _LoadAdaptiveScheme(n, J))
    tc.register_kernel("load-adaptive", _LoadAdaptiveKernel)

    def host_only(n, J, **kw):
        sch = tc.GCScheme(n, 1, J, prefer_rep=False)
        sch.name, sch.design_model = "host-only", _HostOnlyModel()
        return sch

    tc.register_scheme("host-only", host_only)
    tc.register_kernel("host-only", tk.GCKernel)
    try:
        with pytest.raises(NotImplementedError, match="round_loads"):
            tc.simulate_batch([("load-adaptive", {})], traces, device=CPU)
        with pytest.raises(NotImplementedError, match="min_drops_batch"):
            tc.simulate_lockstep("host-only", {}, traces, device=CPU)
        # nor does the all-or-nothing gate check such a model cell by cell on the host
        with pytest.raises(NotImplementedError, match="suffix_ok_batch"):
            tc.simulate_lockstep("host-only", {}, traces, waitout="all", device=CPU)
        # a scheme without a lockstep kernel runs on the host only when asked
        tc.register_scheme("no-kernel", lambda n, J, **kw: tc.NoCodingScheme(n, J))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        with pytest.raises(NotImplementedError, match="without a lockstep kernel"):
            tc.simulate_batch([("no-kernel", {})], traces, device="cuda")
    finally:
        for name in ("load-adaptive", "host-only", "no-kernel"):
            T_FACTORIES.pop(name, None)
            tk._KERNELS.pop(name, None)


def test_entry_points_run_on_the_card_unless_asked(monkeypatch):
    """With no card, the default device raises instead of running elsewhere."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    traces = _traces(8, 10, 1)
    for call in (lambda: tc.simulate_batch([("gc", {"s": 1})], traces),
                 lambda: tc.simulate_lockstep("gc", {"s": 1}, traces),
                 lambda: tc.select_parameters("gc", 8, traces[0], grid=[{"s": 1}]),
                 lambda: tc.make_kernel(tc.make_scheme("gc", 8, 4, s=1)),
                 lambda: tk.GateKernel(tst.PerRoundModel(1), 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# -- on the card ------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", CONFIGS, ids=IDS)
@pytest.mark.parametrize("waitout", ["selective", "all"])
def test_lockstep_on_the_card_matches_the_cpu(cuda_device, name, kw, waitout):
    """The card's run equals the CPU's under the device contract, and each
    kernel launches exactly as often as the CPU run calls its plain version."""
    n, cells = 40, 16
    traces = _traces(n, 26, cells, seed0=70)
    counters = ((gw_kernel.window_stats, "launches"), (gw_kernel.buffer_stats, "launches"),
                (gw_ref.window_stats, "calls"), (gw_ref.buffer_stats, "calls"))
    for fn, attr in counters:
        setattr(fn, attr, 0)
    want = tc.simulate_lockstep(name, kw, traces, alpha=6.0, waitout=waitout, device=CPU)
    got = tc.simulate_lockstep(name, kw, traces, alpha=6.0, waitout=waitout, device=cuda_device)
    launches, calls = [[getattr(fn, attr) for fn, attr in counters[i:i + 2]] for i in (0, 2)]
    assert launches == calls
    for w, g in zip(want, got):
        assert w.job_done_round == g.job_done_round and w.waitouts == g.waitouts
        assert (w.effective_pattern == g.effective_pattern).all()
        assert np.allclose(w.round_times, g.round_times)
