"""The port's grid fusion (``repro_torch.core.batch``: ``grid_plan``, shape
buckets, the kernels' ``fused_params`` / ``bind_fused``) against the JAX
package.

The reference's fused engine stages each bucket under ``vmap`` and does not
run on the installed JAX, so the port is held to what its contract states
(``tests/test_grid_fused.py``: "identical results either way"): the port's
``grid_plan`` equals the reference's exactly, a fused ``simulate_batch``
equals ``fuse=False`` bit for bit on the CPU, and every cell equals the
reference's numpy engine under ``assert_sim_parity``.  The ``cuda`` test
holds the card's fused run to its per-spec run and to the CPU's.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core import batch as tb
from repro_torch.core import kernel as tk
from repro_torch.core import straggler as tst
from repro_torch.core.schemes import _SCHEME_FACTORIES as T_FACTORIES
from repro_torch.kernels.gate_window import gate_window as gw_kernel
from repro_torch.kernels.gate_window import ref as gw_ref

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
GE = dict(p_ns=0.08, p_sn=0.6, slow_factor=6.0)        # tests/test_grid_fused.py
GE_SIM = dict(p_ns=0.035, p_sn=0.85, slow_factor=6.0)  # benchmarks/run.py's Table-1 chain

# tests/test_grid_fused.py's SPECS: GC-Rep (structural s), two general-GC
# specs that fuse on s, two SR-SGC shapes, two M-SGC specs that fuse on lam
# plus a third shape, and the uncoded baseline
SPECS = [
    ("gc", {"s": 3}),
    ("gc", {"s": 4, "prefer_rep": False}),
    ("gc", {"s": 7, "prefer_rep": False}),
    ("sr-sgc", {"B": 1, "W": 2, "lam": 3}),
    ("sr-sgc", {"B": 2, "W": 3, "lam": 5}),
    ("m-sgc", {"B": 2, "W": 3, "lam": 5}),
    ("m-sgc", {"B": 2, "W": 3, "lam": 7}),
    ("m-sgc", {"B": 1, "W": 3, "lam": 12}),
    ("uncoded", {}),
]
# SPECS and the fusions that n = 12 does not reach otherwise: SR-SGC on the
# general code (lam and its derived s per cell, a 3-row WindowwiseOr window),
# and both clustered baselines on s
WIDE = SPECS + [
    ("sr-sgc", {"B": 1, "W": 3, "lam": 3, "prefer_rep": False}),
    ("sr-sgc", {"B": 1, "W": 3, "lam": 6, "prefer_rep": False}),
    ("dc-gc", {"C": 4, "s": 0}),
    ("dc-gc", {"C": 4, "s": 2}),
    ("sb-gc", {"C": 3, "s": 1}),
    ("sb-gc", {"C": 3, "s": 3}),
]


@pytest.fixture(scope="module")
def rc():
    """The JAX package's ``repro.core`` (its numpy engine and planner)."""
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


def _same(a, b):
    """Bit for bit: bookkeeping, patterns and every float time."""
    return (a.scheme == b.scheme and a.job_done_round == b.job_done_round
            and a.waitouts == b.waitouts and a.normalized_load == b.normalized_load
            and np.array_equal(a.effective_pattern, b.effective_pattern)
            and a.total_time == b.total_time and np.array_equal(a.round_times, b.round_times)
            and a.job_done_time == b.job_done_time)


def _scheme_grid(n):
    sys.path.insert(0, str(ROOT))  # examples/ lives at the repo root
    from examples.multimodel_training import scheme_grid

    return [(name, kw) for _, name, kw in scheme_grid(n)]


# -- the planner ------------------------------------------------------------------------


def _plan_cases():
    n256 = dict(n=256, rounds=30, num=1, seed0=100, **GE_SIM)
    return {
        "specs": (lambda: SPECS, dict(n=12, rounds=18, num=2), {}),
        "specs-all": (lambda: SPECS, dict(n=12, rounds=18, num=2), {"waitout": "all"}),
        "wide": (lambda: WIDE, dict(n=12, rounds=22, num=3, seed0=20), {}),
        "m-sgc-256": (lambda: [("m-sgc", p) for p in tc.default_grid("m-sgc", 256)], n256, {}),
        "gc-256": (lambda: [("gc", p) for p in tc.default_grid("gc", 256)], n256, {}),
        "sr-sgc-256": (lambda: [("sr-sgc", p) for p in tc.default_grid("sr-sgc", 256)], n256,
                       {}),
        "scheme-grid-256": (lambda: _scheme_grid(256), dict(n=256, rounds=40, num=2), {}),
        "ragged": (lambda: [("gc", {"s": 3}), ("sr-sgc", {"B": 2, "W": 4, "lam": 3}),
                            ("m-sgc", {"B": 2, "W": 3, "lam": 5}), ("uncoded", {})],
                   dict(n=12, rounds=22, num=2, seed0=40), {}),
        "seeds": (lambda: [("sb-gc", {"C": 3, "s": 1}), ("sb-gc", {"C": 3, "s": 2}),
                           ("gc", {"s": 3})],
                  dict(n=12, rounds=14, num=2, seed0=60), {"seeds": (0, 1, 2)}),
    }


# the reference's bucket counts at n = 256 over a 30-round probe
BUCKETS = {"m-sgc-256": [33] * 4, "gc-256": [1, 1, 27, 1, 1, 1, 1],
           "scheme-grid-256": [1] * 7, "ragged": [1, 1, 1]}


@pytest.mark.parametrize("case", list(_plan_cases()))
def test_grid_plan_equals_the_reference(rc, case):
    specs_fn, tr, kw = _plan_cases()[case]
    specs = specs_fn()
    n, rounds, num = tr.pop("n"), tr.pop("rounds"), tr.pop("num")
    traces = _traces(n, rounds, num, **tr)
    got = tc.grid_plan(specs, traces, **kw)
    assert got == rc.grid_plan(specs, traces, **kw)
    if case in BUCKETS:
        assert [len(b["specs"]) for b in got["buckets"]] == BUCKETS[case]
    if case == "sr-sgc-256":
        assert len(got["buckets"]) == 96
    if case == "ragged":
        assert got["infeasible"] == [1]
    # every spec lands in exactly one place
    placed = sorted(sum((b["specs"] for b in got["buckets"]), []) + got["fallback"]
                    + got["infeasible"])
    assert sorted(set(placed)) == list(range(len(specs)))


# -- fused == per-spec == the reference ----------------------------------------------------


@pytest.mark.parametrize("waitout", ["selective", "all"])
def test_fused_equals_per_spec_and_the_reference(rc, parity, waitout):
    n, rounds, cells = 12, 22, 3
    traces = _traces(n, rounds, cells, seed0=20)
    loops = tb._round_loop.calls
    fused = tc.simulate_batch(WIDE, traces, alpha=6.0, waitout=waitout, device=CPU, fuse=True)
    assert tb._round_loop.calls - loops == len(tc.grid_plan(WIDE, traces)["buckets"]) == 10
    perspec = tc.simulate_batch(WIDE, traces, alpha=6.0, waitout=waitout, device=CPU,
                                fuse=False)
    oracle = rc.simulate_batch(WIDE, traces, alpha=6.0, waitout=waitout)
    for si in range(len(WIDE)):
        for c in range(cells):
            assert _same(perspec[si, 0, c], fused[si, 0, c]), (WIDE[si], c)
            parity(oracle[si, 0, c], fused[si, 0, c], exact=False)  # the device contract
            parity(oracle[si, 0, c], fused[si, 0, c], exact=True)   # and, on the CPU, bits


def test_fused_heterogeneous_alpha(rc, parity):
    """A per-worker (n,) alpha broadcasts per member exactly as the per-spec
    path builds it."""
    n, rounds, cells = 12, 14, 2
    alpha = tst.LambdaTraceGenerator(n=n, seed=7, hetero=0.4).worker_alpha()
    traces = np.stack([tst.LambdaTraceGenerator(n=n, seed=7 + k, hetero=0.4, speed_seed=9)
                       .sample_delays(rounds) for k in range(cells)])
    specs = [("gc", {"s": s, "prefer_rep": False}) for s in (3, 4, 5)] + \
        [("dc-gc", {"C": 3, "s": 2}), ("m-sgc", {"B": 1, "W": 2, "lam": 4}),
         ("m-sgc", {"B": 1, "W": 2, "lam": 6})]
    fused = tc.simulate_batch(specs, traces, alpha=alpha, device=CPU)
    perspec = tc.simulate_batch(specs, traces, alpha=alpha, device=CPU, fuse=False)
    oracle = rc.simulate_batch(specs, traces, alpha=alpha)
    for si in range(len(specs)):
        for c in range(cells):
            assert _same(perspec[si, 0, c], fused[si, 0, c])
            parity(oracle[si, 0, c], fused[si, 0, c], exact=True)


def test_fused_seed_fan_out(rc, parity):
    """sb-gc is seed-sensitive: each seed is its own bucket (its block draw),
    s fuses within it; gc's row is shared across the seed axis."""
    n, rounds, seeds = 12, 14, (0, 1, 2)
    traces = _traces(n, rounds, 2, seed0=60)
    specs = [("sb-gc", {"C": 3, "s": 1}), ("sb-gc", {"C": 3, "s": 2}), ("gc", {"s": 3})]
    plan = tc.grid_plan(specs, traces, seeds=seeds)
    assert [b["specs"] for b in plan["buckets"]] == [[0, 1], [0, 1], [0, 1], [2]]
    fused = tc.simulate_batch(specs, traces, seeds=seeds, alpha=6.0, device=CPU)
    perspec = tc.simulate_batch(specs, traces, seeds=seeds, alpha=6.0, device=CPU, fuse=False)
    oracle = rc.simulate_batch(specs, traces, seeds=seeds, alpha=6.0)
    for si in range(len(specs)):
        for ki in range(len(seeds)):
            for c in range(2):
                assert _same(perspec[si, ki, c], fused[si, ki, c])
                parity(oracle[si, ki, c], fused[si, ki, c], exact=True)
    assert fused[0, 0, 0] is not fused[0, 1, 0]   # fanned out, one run a seed
    assert fused[2, 0, 0] is fused[2, 1, 0]       # shared


# the reference's fragile-gc fixture (repro/core/testing.py), in the port


class FragileGCScheme(tc.GCScheme):
    """General-code GC whose design model admits up to ``d`` stragglers per
    round while only ``s`` decode: admitted rounds with more than ``s``
    stragglers kill their cell."""

    name = "fragile-gc"

    def __init__(self, n, J, *, s=1, d=None, seed=0):
        super().__init__(n, s, J, prefer_rep=False, seed=seed)
        self.d = s if d is None else d
        self.design_model = tst.PerRoundModel(self.d)


class FragileGCKernel(tk.GCKernel):
    """Both thresholds fuse (``s`` into the decode count, ``d`` into the gate
    member), so a doomed spec and healthy ones share one bucket."""

    name = "fragile-gc"

    def __init__(self, scheme, device="cuda"):
        super().__init__(scheme, device)
        self.fused_params = ("s", "d")

    def bind_fused(self, scalars):
        kernel, model = self, self.design_model
        if "s" in scalars:
            kernel = tk._rebind_scalars(self, code=tk._rebind_scalars(self.code, s=scalars["s"]))
        if "d" in scalars:
            model = tk._rebind_scalars(model, s=scalars["d"])
        return kernel, model


@pytest.fixture
def fragile(rc):
    from repro.core import testing as rt

    rt.register_fragile_gc()
    tc.register_scheme("fragile-gc", lambda n, J, **kw: FragileGCScheme(n, J, **kw))
    tc.register_kernel("fragile-gc", FragileGCKernel)
    yield
    rt.unregister_fragile_gc()
    T_FACTORIES.pop("fragile-gc", None)
    tk._KERNELS.pop("fragile-gc", None)


@pytest.mark.parametrize("waitout", ["selective", "all"])
def test_dead_lanes_do_not_change_their_neighbours(rc, parity, fragile, waitout):
    """A spec whose cells die shares a bucket with healthy specs: its dead
    cells are None, and every other cell equals the per-spec run and the
    reference."""
    n, rounds, cells = 12, 18, 3
    traces = _traces(n, rounds, cells, seed0=80)
    specs = [("fragile-gc", {"s": 4, "d": 4}), ("fragile-gc", {"s": 1, "d": 6}),
             ("fragile-gc", {"s": 5, "d": 5})]
    plan = tc.grid_plan(specs, traces, waitout=waitout)
    assert plan == rc.grid_plan(specs, traces, waitout=waitout)
    assert [b["fused"] for b in plan["buckets"]] == [["s", "d"]]
    fused = tc.simulate_batch(specs, traces, alpha=6.0, waitout=waitout, strict=False,
                              device=CPU)
    perspec = tc.simulate_batch(specs, traces, alpha=6.0, waitout=waitout, strict=False,
                                device=CPU, fuse=False)
    oracle = rc.simulate_batch(specs, traces, alpha=6.0, waitout=waitout, strict=False)
    assert any(r is None for r in fused[1].ravel())
    for si in range(len(specs)):
        for c in range(cells):
            assert (fused[si, 0, c] is None) == (perspec[si, 0, c] is None) \
                == (oracle[si, 0, c] is None)
            if fused[si, 0, c] is not None:
                assert _same(perspec[si, 0, c], fused[si, 0, c])
                parity(oracle[si, 0, c], fused[si, 0, c], exact=True)
    for si in (0, 2):
        assert all(r is not None for r in fused[si].ravel())
    with pytest.raises(AssertionError, match="wait-out contract"):
        tc.simulate_batch(specs, traces, alpha=6.0, waitout=waitout, device=CPU)


# -- what the planner cannot stage -------------------------------------------------------


class _OddModel(tst.StragglerModel):
    """A model without the vectorized hooks (the reference's fallback case)."""

    def conforms(self, pattern):
        return bool(pattern.sum() % 2 == 0) or not pattern.any()

    def suffix_ok(self, win):
        return not win.any()

    @property
    def window(self):
        return 1


class _LoadAdaptiveKernel(tk.UncodedKernel):
    name = "load-adaptive-fused"

    def round_loads(self, state, t):
        return super().round_loads(state, t) * (1 + t % 2)


@pytest.fixture
def unstageable():
    def odd(n, J, **kw):
        sch = tc.NoCodingScheme(n, J)
        sch.name, sch.design_model = "odd-gate-fused", _OddModel()
        return sch

    def adaptive(n, J, **kw):
        sch = tc.NoCodingScheme(n, J)
        sch.name = "load-adaptive-fused"
        return sch

    tc.register_scheme("odd-gate-fused", odd)
    tc.register_kernel("odd-gate-fused", tk.UncodedKernel)
    tc.register_scheme("load-adaptive-fused", adaptive)
    tc.register_kernel("load-adaptive-fused", _LoadAdaptiveKernel)
    yield
    for name in ("odd-gate-fused", "load-adaptive-fused"):
        T_FACTORIES.pop(name, None)
        tk._KERNELS.pop(name, None)


def test_unstageable_specs_go_to_the_per_spec_path(unstageable, rc, parity):
    """The planner routes a gate without ``min_drops_batch`` (selective) and
    load-adaptive loads to the per-spec path, which runs them as the
    reference's numpy engine does, with or without fusion; the stageable spec
    beside them still fuses."""
    from repro.core import kernel as rk
    from repro.core import straggler as rst
    from repro.core.schemes import _SCHEME_FACTORIES as R_FACTORIES

    class RefOddModel(rst.StragglerModel):
        def conforms(self, pattern):
            return bool(pattern.sum() % 2 == 0) or not pattern.any()

        def suffix_ok(self, win):
            return not win.any()

        @property
        def window(self):
            return 1

    class RefLoadAdaptiveKernel(rk.UncodedKernel):
        name = "load-adaptive-fused"

        def round_loads(self, state, t):
            return super().round_loads(state, t) * (1 + t % 2)

    def odd(n, J, **kw):
        sch = rc.NoCodingScheme(n, J)
        sch.name, sch.design_model = "odd-gate-fused", RefOddModel()
        return sch

    def adaptive(n, J, **kw):
        sch = rc.NoCodingScheme(n, J)
        sch.name = "load-adaptive-fused"
        return sch

    rc.register_scheme("odd-gate-fused", odd)
    rk.register_kernel("odd-gate-fused", rk.UncodedKernel)
    rc.register_scheme("load-adaptive-fused", adaptive)
    rk.register_kernel("load-adaptive-fused", RefLoadAdaptiveKernel)
    n = 12
    traces = _traces(n, 12, 2, seed0=70)
    specs = [("odd-gate-fused", {}), ("load-adaptive-fused", {}), ("gc", {"s": 3})]
    try:
        plan = tc.grid_plan(specs, traces)
        assert plan == rc.grid_plan(specs, traces)
        assert plan["fallback"] == [0, 1] and [b["specs"] for b in plan["buckets"]] == [[2]]
        assert tc.grid_plan(specs, traces, waitout="all")["fallback"] == [1]
        for waitout in ("selective", "all"):
            want = rc.simulate_batch(specs, traces, alpha=6.0, waitout=waitout)
            fused, perspec = (tc.simulate_batch(specs, traces, alpha=6.0, waitout=waitout,
                                                device=CPU, fuse=fuse) for fuse in (True, False))
            for w, f, p in zip(want.ravel(), fused.ravel(), perspec.ravel()):
                parity(w, f, exact=True)
                assert _same(p, f)
    finally:
        for name in ("odd-gate-fused", "load-adaptive-fused"):
            R_FACTORIES.pop(name, None)
            rk._KERNELS.pop(name, None)


# -- per-cell thresholds in the models' hooks ---------------------------------------------


def _fused_model_cases(n):
    """(model at one threshold, its fused field) for every model a kernel
    rebinds."""
    blocks = tuple(int(b) for b in np.arange(n) % 3)
    return {
        "per-round": (lambda v: tst.PerRoundModel(v), "s", (0, 1, 2, 3)),
        "bursty": (lambda v: tst.BurstyModel(2, 4, v), "lam", (1, 2, 3, 5)),
        "arbitrary": (lambda v: tst.ArbitraryModel(2, 4, v), "lam", (1, 2, 3, 5)),
        "dynamic-cluster": (lambda v: tst.DynamicClusterModel(n, 3, v), "s", (0, 1, 2, 3)),
        "stochastic-block": (lambda v: tst.StochasticBlockModel(n, 3, v, blocks), "s",
                             (0, 1, 2, 3)),
    }


@pytest.mark.parametrize("label", list(_fused_model_cases(12)))
def test_model_hooks_take_per_cell_thresholds(label):
    """A model rebound with a (cells,) threshold tensor gives, cell by cell,
    what the model at that cell's threshold gives, for every committed-buffer
    depth of its window (inside a WindowwiseOr too, where a per-round member
    sees buffer rows)."""
    n, per = 12, 16
    make, field, values = _fused_model_cases(n)[label]
    cells = per * len(values)
    thr = torch.tensor(values).repeat_interleave(per)
    fused = tk._rebind_scalars(make(values[0]), **{field: thr})
    window = max(fused.window, 3)
    wrap = label == "per-round"
    rng = np.random.default_rng(sum(map(ord, label)))
    for kh in range(window):
        buf = torch.from_numpy(rng.random((cells, kh, n)) < 0.2)
        cand = torch.from_numpy(rng.random((cells, n)) < 0.3)
        cost = torch.from_numpy(rng.integers(1, 5, (cells, n)).astype(np.float64))
        order = torch.argsort(torch.where(cand, cost, torch.inf), dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(1, order, torch.arange(n).expand(cells, n))
        win = torch.cat([buf, cand[:, None]], dim=1)

        def hooks(m, rows):
            if wrap:  # a per-round member inside a multi-row window
                m = tst.WindowwiseOr((tst.BurstyModel(1, window, 0), m), window)
            elif kh >= m.window:
                return []
            b, c, co = buf[rows], cand[rows], cost[rows]
            return [m.suffix_ok_batch(win[rows][:, -m.window:] if not wrap else win[rows]),
                    m.min_drops_batch(b, c, rank[rows], order[rows]),
                    m.admit_fn_batch(b)(c), m.drops_lower_bound_fn_batch(b, co)(c)]

        got = hooks(fused, slice(None))
        for i, v in enumerate(values):
            rows = slice(i * per, (i + 1) * per)
            for g, w in zip(got, hooks(make(v), rows)):
                assert torch.equal(g[rows], w), (label, kh, v)


# -- App.-J selection and the switch --------------------------------------------------------


@pytest.mark.parametrize("name,loops", [("m-sgc", 4), ("gc", 7)])
def test_selection_runs_one_loop_a_bucket(rc, name, loops):
    """select_parameters over the default grid at n 256 runs one round loop a
    bucket (m-sgc: 4 for its 132 candidates) and picks the reference's
    candidate with the same per-job time (its numpy engine, which its own
    tests hold to its legacy loop; the port's legacy loop is the next test's)."""
    n = 256
    src = tst.GilbertElliotSource(n=n, seed=100, **GE_SIM)
    probe = src.sample_delays(30)
    before = tb._round_loop.calls
    got = tc.select_parameters(name, n, probe, alpha=src.alpha, device=CPU)
    assert tb._round_loop.calls - before == loops
    want = rc.select_parameters(name, n, probe, alpha=src.alpha)
    assert (got.params, got.load, got.est_time) == (want.params, want.load, want.est_time)


def test_selection_fused_and_per_spec_agree(monkeypatch):
    """The same candidate and per-job time with REPRO_GRID_FUSE off, where one
    round loop runs per candidate, and the legacy per-candidate loop's
    candidate, tie-break included (grid order)."""
    n = 64
    src = tst.GilbertElliotSource(n=n, seed=5, **GE_SIM)
    probe = src.sample_delays(24)
    grid = tc.default_grid("m-sgc", n)
    fused = tc.select_parameters("m-sgc", n, probe, alpha=src.alpha, device=CPU)
    monkeypatch.setenv("REPRO_GRID_FUSE", "0")
    before = tb._round_loop.calls
    perspec = tc.select_parameters("m-sgc", n, probe, alpha=src.alpha, device=CPU)
    assert tb._round_loop.calls - before == len(grid)
    assert (fused.params, fused.load, fused.est_time) == \
        (perspec.params, perspec.load, perspec.est_time)
    want = tc.select_parameters_legacy("m-sgc", n, probe, alpha=src.alpha)
    assert (fused.params, fused.load) == (want.params, want.load)
    assert fused.est_time == pytest.approx(want.est_time)


@pytest.mark.parametrize("raw,want,warns", [
    (None, True, False), ("", True, False), ("1", True, False), ("TRUE", True, False),
    (" on ", True, False), ("yes", True, False), ("0", False, False), ("false", False, False),
    ("Off", False, False), ("no", False, False), ("nope", True, True), ("2", True, True),
])
def test_repro_grid_fuse_is_parsed_as_the_reference(rc, monkeypatch, raw, want, warns):
    import warnings

    from repro.core import batch as rb

    if raw is None:
        monkeypatch.delenv("REPRO_GRID_FUSE", raising=False)
    else:
        monkeypatch.setenv("REPRO_GRID_FUSE", raw)
    for fn in (tb._fuse_enabled, rb._fuse_enabled):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert fn(None) is want
            assert fn(True) is True and fn(False) is False
        assert bool(caught) is warns
        if warns:
            assert "grid fusion stays ON" in str(caught[0].message)


# -- on the card ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("waitout", ["selective", "all"])
def test_fused_on_the_card(cuda_device, waitout):
    """Fused on the card == per-spec on the card bit for bit, == the CPU's
    fused run under the device contract, and each gate-window kernel launches
    as often as the CPU's fused run calls its plain version."""
    n, cells = 48, 8   # C | n for both clustered baselines
    traces = _traces(n, 26, cells, seed0=70)
    counters = ((gw_kernel.window_stats, "launches"), (gw_kernel.buffer_stats, "launches"),
                (gw_ref.window_stats, "calls"), (gw_ref.buffer_stats, "calls"))
    for fn, attr in counters:
        setattr(fn, attr, 0)
    want = tc.simulate_batch(WIDE, traces, alpha=6.0, waitout=waitout, device=CPU)
    got = tc.simulate_batch(WIDE, traces, alpha=6.0, waitout=waitout, device=cuda_device)
    launches, calls = [[getattr(fn, attr) for fn, attr in counters[i:i + 2]] for i in (0, 2)]
    assert launches == calls
    perspec = tc.simulate_batch(WIDE, traces, alpha=6.0, waitout=waitout, device=cuda_device,
                                fuse=False)
    for si in range(len(WIDE)):
        for c in range(cells):
            w, g = want[si, 0, c], got[si, 0, c]
            assert _same(perspec[si, 0, c], g)
            assert w.job_done_round == g.job_done_round and w.waitouts == g.waitouts
            assert (w.effective_pattern == g.effective_pattern).all()
            assert np.allclose(w.round_times, g.round_times)
