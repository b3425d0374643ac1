"""Elastic fault tolerance of the port's harness: the counterparts of the
JAX package's ``tests/test_dist_elastic.py`` and ``tests/test_dist_net.py``
campaigns, in linear mode.

* a killed worker respawns within its budget, rejoins through the
  assignment-ledger replay, and every job still decodes exactly;
* ``degrade="shrink"`` re-solves the scheme on the survivors where
  ``degrade="off"`` aborts;
* a master stopped mid-run resumes from its checkpoint, which the JAX
  package's ``load_blob`` reads too, and the resumed recording replays bit
  for bit through ``simulate_fast``;
* a TCP partition heals with no respawn burned, and a kill wave passes the
  chaos auditor, which also refuses to pass vacuously.
"""

import numpy as np
import pytest

from repro_torch.core import GilbertElliotSource, make_scheme, simulate_fast
from repro_torch.dist import (
    FaultSpec,
    HarnessConfig,
    HarnessError,
    degrade_params,
    kill_wave,
    partition_heal,
    run_campaign,
    run_harness,
)

N = 4
SCALE = 0.01
GE = dict(p_ns=0.15, p_sn=0.5, slow_factor=5.0, jitter=0.05)
MSGC = {"B": 1, "W": 3, "lam": N}


def _delays(rounds, seed=7):
    return GilbertElliotSource(n=N, seed=seed, **GE).sample_delays(rounds)


def _cfg(**kw):
    base = dict(alpha=8.0, time_scale=SCALE, seed=1, round_timeout=0.25)
    base.update(kw)
    return HarnessConfig(**base)


def test_killed_worker_respawns_and_rejoins():
    J, w, r_die = 6, 3, 2
    delays = _delays(J + 6, seed=5)
    cfg = _cfg(faults={w: FaultSpec(kill_after=r_die)}, respawn_max_attempts=2,
               respawn_backoff_s=0.05, respawn_jitter=0.0)
    res = run_harness("m-sgc", N, J, delays, params=MSGC, config=cfg)
    assert not res.aborted, res.abort_reason
    assert sorted(res.decoded_jobs) == list(range(1, J + 1))
    assert res.decode_max_err < 1e-8
    assert res.deaths == [w]
    assert res.respawns >= 1 and res.rejoins >= 1
    kinds = [ev["kind"] for ev in res.events if ev.get("worker") == w]
    assert kinds.index("death") < kinds.index("respawn") < kinds.index("rejoin")
    assert not res.trace_model.pattern[r_die:, w].all()
    wc = res.ledger.worker_counters()
    assert wc["deaths"][w] >= 1 and wc["respawns"][w] >= 1 and wc["rejoins"][w] >= 1
    assert all(wc["deaths"][i] == 0 for i in range(N) if i != w)
    back = type(res.trace_model).from_json(res.trace_model.to_json())
    assert back.events == res.trace_model.events


def test_degrade_shrink_finishes_where_off_aborts():
    J = 6
    params = {"s": 1, "prefer_rep": False}
    delays = _delays(J + 6, seed=3)
    faults = {1: FaultSpec(kill_after=2), 3: FaultSpec(kill_after=3)}
    off = run_harness("gc", N, J, delays, params=params,
                      config=_cfg(faults=dict(faults), degrade="off"))
    assert off.aborted and "dead worker" in off.abort_reason
    res = run_harness("gc", N, J, delays, params=params,
                      config=_cfg(faults=dict(faults), degrade="shrink"))
    assert not res.aborted, res.abort_reason
    assert res.degraded >= 1
    assert sorted(res.decoded_jobs) == list(range(1, J + 1))
    assert res.decode_max_err < 1e-8
    assert set(res.deaths) == {1, 3}
    notes = [ev for ev in res.events if ev["kind"] == "degrade"]
    assert notes and "jobs re-run" in notes[0]["note"]


def test_degrade_params_equal_the_reference():
    from repro.dist import degrade_params as ref_degrade

    for args in [("gc", {"s": 3}, 3), ("m-sgc", {"B": 1, "W": 3, "lam": 8}, 5),
                 ("dc-gc", {"C": 4, "s": 1}, 6), ("dc-gc", {"C": 4, "s": 1}, 8),
                 ("sr-sgc", {"B": 1, "W": 2, "lam": 6}, 4), ("uncoded", {}, 3)]:
        assert degrade_params(*args) == ref_degrade(*args)
    with pytest.raises(HarnessError):
        degrade_params("gc", {"s": 1}, 1)


@pytest.mark.parametrize("name,params", [("gc", {"s": 1}), ("m-sgc", MSGC)])
def test_master_resumes_bit_identically(tmp_path, name, params):
    from repro.checkpoint.io import load_blob as ref_load_blob

    J, stop_at = 5, 3
    delays = _delays(J + 4, seed=11)
    ck = str(tmp_path / "master.npz")
    first = run_harness(name, N, J, delays, params=params,
                        config=_cfg(checkpoint_path=ck, checkpoint_every=1,
                                    stop_after_round=stop_at))
    assert first.stopped and not first.aborted
    assert first.checkpoint_path == ck and first.ledger.rounds == stop_at
    state = ref_load_blob(ck)                  # the JAX package reads it
    assert state["version"] == 1 and state["scheme"] == name
    assert int(state["global_round"]) == stop_at
    np.testing.assert_array_equal(state["epoch"]["pattern"],
                                  first.trace_model.pattern[:stop_at])
    res = run_harness(name, N, J, delays, params=params,
                      config=_cfg(checkpoint_path=ck, checkpoint_every=1), resume_from=ck)
    assert not res.aborted, res.abort_reason
    assert sorted(res.decoded_jobs) == list(range(1, J + 1))
    assert res.decode_max_err < 1e-8
    sim = simulate_fast(make_scheme(name, N, J, **params), delays, mu=1.0, alpha=8.0, J=J)
    np.testing.assert_array_equal(res.trace_model.pattern, sim.effective_pattern)
    assert np.allclose(res.analytic_round_times, sim.round_times * SCALE)
    assert res.decoded_jobs == sim.job_done_round
    with pytest.raises(HarnessError, match="does not match"):
        run_harness("uncoded", N, J, delays, config=_cfg(), resume_from=ck)


def test_partition_heal_campaign_zero_respawns():
    report = run_campaign(partition_heal(N, 6, worker=1, at_round=3, heal_s=0.8),
                          time_scale=SCALE)
    assert report.passed, report.violations
    res = report.result
    assert res.partitions >= 1 and res.heals >= 1 and res.respawns == 0
    assert sorted(res.decoded_jobs) == list(range(1, 7))
    kinds = [ev["kind"] for ev in res.events]
    assert "partition" in kinds and "heal" in kinds and "respawn" not in kinds


def test_kill_wave_campaign_passes_and_audit_is_not_vacuous():
    report = run_campaign(kill_wave(N, 6, {1: 2, 2: 4}, respawn_backoff_s=0.05),
                          time_scale=SCALE)
    assert report.passed, report.violations
    assert report.result.respawns >= 2 and report.result.rejoins >= 2
    camp = kill_wave(N, 4, {})
    camp.min_respawns = 1
    report = run_campaign(camp, time_scale=SCALE)
    assert not report.passed
    assert any("respawns" in v for v in report.violations)
    assert report.summary()["passed"] is False and report.summary()["decoded"] == 4
