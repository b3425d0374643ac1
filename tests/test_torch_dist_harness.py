"""The port's execution harness (``repro_torch.dist.run_harness``) against
the JAX package's, in linear mode, over pipes and over TCP.

Linear mode is numpy on the host in both packages (the protocol's
closed-form oracle), and the gate decides on planned times, not on the wall
clock, so a fault-free run of either package on the same delays and seed
admits the same straggler pattern, decodes each job in the same round, and
reports the same analytic makespan, bit for bit.  Each decoded gradient is
certified by the master against ``linear_job_data``'s closed-form full
gradient (``decode_max_err``).  Then the port's own fault paths: message
drops recovered by resends, and a dead worker degraded to an
always-straggler row that replays through the simulator.
"""

import numpy as np
import pytest

from repro_torch.core import GilbertElliotSource, make_scheme, simulate_fast
from repro_torch.dist import FaultSpec, HarnessConfig, TaskComputer, linear_job_data, run_harness

N = 4
SCALE = 0.01
GE = dict(p_ns=0.15, p_sn=0.5, slow_factor=5.0, jitter=0.05)


def _delays(rounds, seed=7):
    return GilbertElliotSource(n=N, seed=seed, **GE).sample_delays(rounds)


def _kw(**kw):
    base = dict(alpha=8.0, time_scale=SCALE, seed=1)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def rdist():
    import repro.dist

    return repro.dist


def test_linear_job_data_and_truth_equal_the_reference(rdist):
    from repro.dist.worker import TaskComputer as RefComputer

    for job in (1, 4):
        for a, b in zip(linear_job_data(1, job, 64, 8), rdist.linear_job_data(1, job, 64, 8)):
            np.testing.assert_array_equal(a, b)
    bounds = [(0, 20), (20, 40), (40, 64)]
    got = TaskComputer(1, "linear", 8, 64, bounds)
    want = RefComputer(1, "linear", 8, 64, bounds)
    X, y, theta = linear_job_data(1, 3, 64, 8)
    np.testing.assert_array_equal(got.full_grad(3), X.T @ (X @ theta - y))
    np.testing.assert_array_equal(got.full_grad(3), want.full_grad(3))
    item = {"job": 3, "chunks": [0, 2], "coeffs": [0.5, -1.25]}
    np.testing.assert_array_equal(got.value(item), want.value(item))
    np.testing.assert_array_equal(got.chunk_grad(3, 1), want.chunk_grad(3, 1))


@pytest.mark.parametrize("transport", ["pipe", "tcp"])
@pytest.mark.parametrize("name,params", [
    ("gc", {"s": 1}),
    ("m-sgc", {"B": 1, "W": 3, "lam": N}),
])
def test_fault_free_run_equals_the_reference(rdist, transport, name, params):
    J = 5
    delays = _delays(J + 4)
    got = run_harness(name, N, J, delays, params=params,
                      config=HarnessConfig(**_kw(transport=transport)))
    want = rdist.run_harness(name, N, J, delays, params=params,
                             config=rdist.HarnessConfig(**_kw(transport=transport)))
    for res in (got, want):
        assert not res.aborted, res.abort_reason
        assert sorted(res.decoded_jobs) == list(range(1, J + 1))
        assert res.decode_max_err < 1e-8
    np.testing.assert_array_equal(got.trace_model.pattern, want.trace_model.pattern)
    assert got.decoded_jobs == want.decoded_jobs
    assert got.analytic_makespan == want.analytic_makespan
    np.testing.assert_array_equal(got.analytic_round_times, want.analytic_round_times)
    assert got.ledger.waitouts() == want.ledger.waitouts()
    # and both replay bit for bit through the port's simulator
    sim = simulate_fast(make_scheme(name, N, J, **params), delays, mu=1.0, alpha=8.0, J=J)
    np.testing.assert_array_equal(got.trace_model.pattern, sim.effective_pattern)
    assert np.allclose(got.analytic_round_times, sim.round_times * SCALE)
    assert got.decoded_jobs == sim.job_done_round
    assert got.measured_makespan >= 0.9 * got.analytic_makespan
    back = type(got.trace_model).from_json(got.trace_model.to_json())
    np.testing.assert_array_equal(back.pattern, got.trace_model.pattern)
    if transport == "tcp":
        assert got.partitions == 0 and got.heals == 0 and not got.deaths
        wc = got.ledger.worker_counters()
        assert all(w > 0 for w in wc["wire_send_s"])
        assert all(w > 0 for w in wc["wire_recv_s"])


def test_message_drops_recover_via_retry():
    J = 4
    delays = _delays(J + 2, seed=11)
    cfg = HarnessConfig(**_kw(round_timeout=0.25,
                              faults={1: FaultSpec(drop_rounds=frozenset({1, 3}))}))
    res = run_harness("gc", N, J, delays, params={"s": 1}, config=cfg)
    assert not res.aborted, res.abort_reason
    assert res.retries >= 1
    assert sorted(res.decoded_jobs) == list(range(1, J + 1))
    assert res.decode_max_err < 1e-8
    led = res.ledger
    assert led.rounds == len(res.round_times)
    for rec in led.records:
        for st in rec.stats:
            if st.reported is not None:
                assert st.sent <= st.reported
                assert st.compute_s >= 0 and st.delay_s >= 0
    assert led.measured_makespan() == pytest.approx(res.measured_makespan)
    assert res.trace_model.timings.shape == (led.rounds, N)


def test_dead_worker_becomes_always_straggler_without_poisoning_decode():
    from repro.core.testing import dead_worker_delays

    J, r_die, w = 5, 2, 3
    delays = _delays(J + 2, seed=5)
    cfg = HarnessConfig(**_kw(round_timeout=0.25, faults={w: FaultSpec(kill_after=r_die)}))
    res = run_harness("gc", N, J, delays, params={"s": 1}, config=cfg)
    assert not res.aborted, res.abort_reason
    assert res.deaths == [w]
    pat = res.trace_model.pattern
    assert pat[r_die:, w].all()
    assert sorted(res.decoded_jobs) == list(range(1, J + 1))
    assert res.decode_max_err < 1e-8
    sim = simulate_fast(make_scheme("gc", N, J, s=1), dead_worker_delays(delays, w, r_die + 1),
                        mu=1.0, alpha=8.0, J=J)
    np.testing.assert_array_equal(pat, sim.effective_pattern)
