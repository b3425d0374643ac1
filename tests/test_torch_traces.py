"""The port's straggler trace library and the Sec.-6 entry points against
the JAX package's.

The library is numpy RNG from end to end, so the contract is equality:
every scenario's delay stack and alpha, every source's pattern and delays,
the recordings (the port's own byte-identical copies), the ``TraceModel``
JSON text and its errors, the pattern fits and the App.-F load formulas.
Then ``launch.scenarios`` at a tiny size on the CPU: the scenario sweep
(each cell equal to the reference's numpy engine) and the 7-scheme coded
training and multi-model runs, with their gates.
"""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core import bounds as tb
from repro_torch.core import straggler as tst
from repro_torch.launch import scenarios

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


@pytest.fixture(scope="module")
def rc():
    """The JAX package's ``repro.core``."""
    import repro.core

    return repro.core


@pytest.mark.parametrize("n,rounds,num_traces,seed", [(16, 20, 2, 0), (64, 40, 4, 0),
                                                      (8, 16, 1, 0), (12, 30, 3, 7),
                                                      (40, 9, 2, 3)])
def test_trace_library_equals_the_reference(rc, n, rounds, num_traces, seed):
    got = tc.trace_library(n=n, rounds=rounds, num_traces=num_traces, seed=seed)
    want = rc.trace_library(n=n, rounds=rounds, num_traces=num_traces, seed=seed)
    assert [s.name for s in got] == [s.name for s in want]
    assert len(got) == 7
    for g, w in zip(got, want):
        assert g.note == w.note
        assert g.delays.shape == (num_traces, rounds, n)
        np.testing.assert_array_equal(g.delays, w.delays, err_msg=g.name)
        np.testing.assert_array_equal(np.asarray(g.alpha), np.asarray(w.alpha), err_msg=g.name)
        assert isinstance(g.alpha, float) == isinstance(w.alpha, float)
    hetero = next(s for s in got if s.name == "lambda-hetero")
    assert np.shape(hetero.alpha) == (n,)


def test_recordings_are_byte_identical_copies():
    for name in ("harness-ge-bursty", "harness-tcp-netfault"):
        ours = ROOT / "src/repro_torch/core/recordings" / f"{name}.json"
        theirs = ROOT / "src/repro/core/recordings" / f"{name}.json"
        assert ours.read_bytes() == theirs.read_bytes()
    assert tst._RECORDINGS_DIR == (ROOT / "src/repro_torch/core/recordings").resolve()


@pytest.mark.parametrize("name", ["harness-ge-bursty", "harness-tcp-netfault"])
@pytest.mark.parametrize("shape", [None, (8, 30), (24, 12), (5, 7)])
def test_load_recorded_harness_equals_the_reference(rc, name, shape):
    from repro.core.straggler import load_recorded_harness as ref_load

    kw = {} if shape is None else dict(n=shape[0], rounds=shape[1])
    got, want = tc.load_recorded_harness(name, **kw), ref_load(name, **kw)
    np.testing.assert_array_equal(got.pattern, want.pattern)
    assert got.to_json() == want.to_json()
    np.testing.assert_array_equal(got.sample_delays(33), want.sample_delays(33))
    assert got.alpha == want.alpha


def test_sources_equal_the_reference(rc):
    for kw in (dict(n=10, seed=4), dict(n=16, seed=1, hetero=0.4, speed_seed=3),
               dict(n=7, seed=2, hetero=0.35, cold_fraction=1.0, p_event=0.5)):
        got, want = tc.LambdaTraceGenerator(**kw), rc.LambdaTraceGenerator(**kw)
        np.testing.assert_array_equal(got.speed_factors(), want.speed_factors())
        np.testing.assert_array_equal(got.worker_alpha(), want.worker_alpha())
        assert got.alpha == want.alpha
        np.testing.assert_array_equal(got.sample_pattern(25), want.sample_pattern(25))
        np.testing.assert_array_equal(got.sample_delays(25), want.sample_delays(25))
    delays = np.random.default_rng(0).random((6, 5))
    for rounds in (4, 6, 15):
        np.testing.assert_array_equal(tc.TraceSource(delays).sample_delays(rounds),
                                      rc.TraceSource(delays).sample_delays(rounds))
    pat = np.random.default_rng(4).random((6, 10)) < 0.2
    got = tc.TraceModel(pat, base_time=1.0, slow_factor=6.0, jitter=0.0)
    want = rc.TraceModel(pat, base_time=1.0, slow_factor=6.0, jitter=0.0)
    np.testing.assert_array_equal(got.sample_pattern(15), want.sample_pattern(15))
    np.testing.assert_array_equal(got.sample_delays(15), want.sample_delays(15))
    assert (got.n, got.alpha) == (want.n, want.alpha)


def _model(module, with_timings, events=None):
    """tests/test_trace_model_json.py's recording."""
    rng = np.random.default_rng(5)
    pattern = rng.random((7, 5)) < 0.3
    timings = None
    if with_timings:
        timings = rng.random((7, 5)) * 2.0
        timings[pattern] = np.nan
    return module.TraceModel(pattern, base_time=1.25, slow_factor=3.5, jitter=0.07,
                             compute_scale=6.0, seed=11, timings=timings, events=events)


EVENTS = [{"round": 3, "worker": 2, "kind": "death", "note": "process died"},
          {"round": 4, "worker": 2, "kind": "respawn"}]


@pytest.mark.parametrize("with_timings", [False, True])
@pytest.mark.parametrize("events", [None, EVENTS])
def test_trace_model_json_round_trip(rc, with_timings, events):
    got, want = _model(tc, with_timings, events), _model(rc, with_timings, events)
    for indent in (None, 1):
        assert got.to_json(indent=indent) == want.to_json(indent=indent)
    back = tc.TraceModel.from_json(want.to_json())
    assert json.loads(back.to_json())["version"] == (1 if events is None else 2)
    np.testing.assert_array_equal(back.pattern, got.pattern)
    assert back.events == events
    if with_timings:
        np.testing.assert_array_equal(back.timings, got.timings)
    np.testing.assert_array_equal(back.sample_delays(20), want.sample_delays(20))


def _payloads():
    """Foreign and malformed recordings (tests/test_trace_model_json.py's)."""
    base = json.loads(_model(tst, True).to_json())

    def edit(fn):
        obj = json.loads(json.dumps(base))
        fn(obj)
        return json.dumps(obj)

    return {
        "foreign": json.dumps({"kind": "other", "version": 1}),
        "list": json.dumps([1, 2, 3]),
        "version-99": edit(lambda o: o.update(version=99)),
        "version-str": edit(lambda o: o.update(version="one")),
        "missing": edit(lambda o: [o.pop("stragglers"), o.pop("base_time")]),
        "worker-range": edit(lambda o: o["stragglers"].__setitem__(2, [0, 99])),
        "straggler-rows": edit(lambda o: o.update(stragglers=o["stragglers"][:-1])),
        "timing-short": edit(lambda o: o["timings"].__setitem__(1, o["timings"][1][:-1])),
        "timing-str": edit(lambda o: o["timings"][0].__setitem__(0, "fast")),
        "timing-rows": edit(lambda o: o.update(timings=o["timings"][:-1])),
        "events-kind": edit(lambda o: o.update(version=2, events=[{"round": 1}])),
        "events-str": edit(lambda o: o.update(version=2, events="death")),
    }


@pytest.mark.parametrize("label", list(_payloads()))
def test_trace_model_json_errors_equal_the_reference(rc, label):
    text = _payloads()[label]
    with pytest.raises(ValueError) as want:
        rc.TraceModel.from_json(text)
    with pytest.raises(ValueError) as got:
        tc.TraceModel.from_json(text)
    assert str(got.value) == str(want.value)


def test_pattern_fits_equal_the_reference(rc):
    from repro.core import straggler as rst

    pats = [tc.GilbertElliotSource(n=128, p_ns=0.05, p_sn=0.7, seed=3).sample_pattern(400),
            tc.GilbertElliotSource(n=64, p_ns=0.04, p_sn=0.6, seed=9).sample_pattern(200),
            np.zeros((50, 8), dtype=bool),
            tc.load_recorded_harness("harness-tcp-netfault").pattern]
    for pat in pats:
        assert tc.fit_gilbert_elliot(pat) == rc.fit_gilbert_elliot(pat)
        np.testing.assert_array_equal(tst.burst_lengths(pat), rst.burst_lengths(pat))
        for q in (0.5, 0.95):
            assert tc.suggest_parameters(pat, quantile=q) == rc.suggest_parameters(pat,
                                                                                   quantile=q)


def test_bounds_equal_the_reference():
    from repro.core import bounds as rb

    for n in (4, 8, 16, 256):
        for s in range(n):
            assert tb.load_gc(n, s) == rb.load_gc(n, s)
        for B in (1, 2, 3):
            for W in range(max(B, 2), B + 5):
                for lam in (0, 1, n // 2, n - 1):
                    for fn in ("load_m_sgc", "lower_bound_bursty", "lower_bound_arbitrary",
                               "load_sr_sgc"):
                        assert getattr(tb, fn)(n, B, W, lam) == getattr(rb, fn)(n, B, W, lam)
                    assert tb.sr_sgc_s(B, W, lam) == rb.sr_sgc_s(B, W, lam)
        assert tb.load_m_sgc(n, 1, 3, n) == rb.load_m_sgc(n, 1, 3, n)   # Remark 3.2
    for fn in ("lower_bound_bursty", "lower_bound_arbitrary"):
        with pytest.raises(ValueError, match="requires"):
            getattr(tb, fn)(8, 3, 2, 1)
    assert tc.load_gc is tb.load_gc and tc.sr_sgc_s is tb.sr_sgc_s


# -- the Sec.-6 entry points, tiny, on the CPU ---------------------------------------------


def test_scheme_grid_is_the_examples():
    import sys

    sys.path.insert(0, str(ROOT))  # examples/ lives at the repo root
    from examples.multimodel_training import scheme_grid

    for n in (4, 8, 12, 16, 64, 256):
        assert scenarios.scheme_grid(n) == scheme_grid(n)


def test_scenario_sweep_equals_the_reference_with_its_gates(rc):
    """The sweep's default specs (bench_scenario_sweep's) at n 16: both gates
    hold, and every cell equals the reference's numpy engine on the same
    scenario; then scheme_grid(16)'s specs, whose gc-rep shares gc's s."""
    from repro.core.testing import assert_sim_parity

    n, rounds, num_traces = 16, 20, 2
    res = scenarios.scenario_sweep(n, rounds, num_traces, device=CPU, quiet=True)
    assert res.eq_load == ("sr-sgc", "gc-rep", "gc", "dc-gc", "sb-gc")
    lib = rc.trace_library(n=n, rounds=rounds, num_traces=num_traces, seed=0)
    assert sorted(res.grids) == sorted(sc.name for sc in lib) == sorted(res.walls)
    for sc in lib:
        want = rc.simulate_batch([(name, p) for _, name, p in res.specs], sc.delays, mu=1.0,
                                 alpha=sc.alpha)
        got = res.grids[sc.name]
        assert got.shape == want.shape == (7, 1, num_traces)
        for w, g in zip(want.ravel(), got.ravel()):
            assert_sim_parity(w, g, exact=True)
        for lb in ("dc-gc", "sb-gc"):
            assert res.means[(sc.name, lb)] <= res.means[(sc.name, "gc")] + 1e-9
    res = scenarios.scenario_sweep(n, rounds, num_traces, scenarios.scheme_grid(n), device=CPU,
                                   quiet=True)
    assert res.eq_load == ("gc-rep", "gc", "dc-gc", "sb-gc")   # s = 3 for all four at n 16


@pytest.fixture
def one_thread():
    """One intra-op thread while a test times steps: under a loaded CPU, a
    team of spinning threads per process turns step times into noise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def thread_ms(fn, reps):
    """Median CPU time of this thread for one call of fn, in ms, over ``reps``
    calls after a warm-up call.  With one intra-op thread the step's work runs
    on the calling thread, so this measures that work alone, whatever other
    processes load the machine with (a host clock would count their time)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.thread_time()
        fn()
        times.append(time.thread_time() - t0)
    return 1e3 * float(np.median(times))


def test_coded_train_gates_on_the_cpu(one_thread):
    """bench_coded_train at its smoke size (n 8, 2 models, 8 jobs): the 7
    schemes through VectorizedCodedTrainer, with its three gates.  Sequences
    of 32 tokens, so that compute, not per-op overhead, sets the isolated
    step time its ratio gate reads; the step is timed by the thread's CPU
    time (``thread_ms``)."""
    res = scenarios.coded_train(8, 2, 8, seq_len=32, step_timer=thread_ms, device=CPU,
                                quiet=True)
    assert len(res.sim_clock) == 14 and res.steps == 7 * 2 * 8
    assert sorted(res.isolated_ms) == sorted(res.loads) and len(res.loads) == 7
    assert res.sim_clock[("ge-bursty", "m-sgc")] < res.sim_clock[("ge-bursty", "gc")]
    assert res.ratio < 1.0 and all(np.isfinite(list(res.final_loss.values())))
    assert res.loads["dc-gc"] == res.loads["sb-gc"] == res.loads["gc"] == 4 / 8


def test_multimodel_training_decodes_every_scheme_exactly():
    runs = scenarios.multimodel_training(jobs=4, workers=8, models=2, check_decodes=True,
                                         device=CPU, quiet=True)
    assert list(runs) == [label for label, _, _ in scenarios.scheme_grid(8)]
    for label, run in runs.items():
        assert run.max_decode_err < 1e-3, label
        assert sorted(run.driver.job_done_time) == [1, 2, 3, 4]
        assert np.isfinite(run.final_losses).all()
        assert run.driver.encodes > 0 or label in ("uncoded",)
    assert runs["m-sgc"].clock < runs["gc"].clock


def test_cli_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["scenarios", "sweep", "--n", "16", "--rounds", "10",
                                     "--traces", "1", "--device", "cpu"])
    scenarios.main()
    out = capsys.readouterr().out
    assert "scenario.ge-bursty.winner" in out and "scenario.sims,49" in out


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: scenarios.scenario_sweep(8, 10, 1),
                 lambda: scenarios.coded_train(8, 2, 2),
                 lambda: scenarios.multimodel_training(2, 8, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
