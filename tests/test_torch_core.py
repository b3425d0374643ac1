"""The port's coding core (``repro_torch.core``) against the JAX package's.

Everything here is numpy bookkeeping, so the contract is exact: encode
matrices, decode vectors, Gilbert-Elliott patterns and delays, gate
verdicts, and every ``JobDecode``, ``chunk_slots`` and ``decode_weights`` of
the five schemes the port runs must equal the reference's bit for bit.
The port's schemes take the descriptor route (``step`` = assign + observe,
``collect_decodes`` = collect); the reference's ``collect_decodes`` reads its
lockstep kernel.  Those are the decodes its trainer consumes, so they are
what the port is held to.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core import straggler as tst

ROOT = Path(__file__).resolve().parents[1]
N = 8
# the five of examples/multimodel_training.py scheme_grid(8) that the port runs
SPEC_LABELS = ("m-sgc", "sr-sgc", "gc-rep", "gc", "uncoded")


@pytest.fixture(scope="module")
def rc():
    """The JAX package's ``repro.core``."""
    import repro.core

    return repro.core


def _specs():
    sys.path.insert(0, str(ROOT))  # examples/ lives at the repo root
    from examples.multimodel_training import scheme_grid

    return [s for s in scheme_grid(N) if s[0] in SPEC_LABELS]


def _decode_tuple(jd):
    return (jd.job, jd.round_done, jd.ell_weights, jd.group_weights, jd.d1_workers)


@pytest.mark.parametrize("n,s", [(4, 1), (6, 2), (8, 3), (9, 2), (12, 2), (16, 2), (8, 0)])
@pytest.mark.parametrize("prefer_rep", [True, False])
def test_gradient_codes_equal_the_reference(rc, n, s, prefer_rep):
    want = rc.make_gradient_code(n, s, prefer_rep=prefer_rep, seed=3)
    got = tc.make_gradient_code(n, s, prefer_rep=prefer_rep, seed=3)
    assert type(got).__name__ == type(want).__name__
    np.testing.assert_array_equal(got.encode_matrix, want.encode_matrix)
    assert got.normalized_load == want.normalized_load
    rng = np.random.default_rng(n * 10 + s)
    for i in range(n):
        np.testing.assert_array_equal(got.chunks_of_worker(i), want.chunks_of_worker(i))
    for _ in range(6):
        surv = sorted(rng.choice(n, size=n - s, replace=False).tolist())
        np.testing.assert_array_equal(got.decode_vector(surv), want.decode_vector(surv))
        assert got.can_decode(surv) == want.can_decode(surv)


def test_decoding_error_on_too_few_survivors():
    code = tc.GradientCode(8, 3, seed=0)
    with pytest.raises(tc.DecodingError):
        code.decode_vector([0, 1, 2, 3])


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("n", [8, 16])
def test_gilbert_elliott_source_is_bit_identical(rc, seed, n):
    want = rc.GilbertElliotSource(n=n, seed=seed)
    got = tc.GilbertElliotSource(n=n, seed=seed)
    np.testing.assert_array_equal(got.sample_pattern(40), want.sample_pattern(40))
    np.testing.assert_array_equal(got.sample_delays(40), want.sample_delays(40))
    assert got.alpha == want.alpha


@pytest.mark.parametrize("label", SPEC_LABELS)
def test_gate_outcomes_equal_the_reference(rc, label):
    """ConformanceGate.admit_partial / force over a GE delay profile, with
    the trainers' mu-rule candidates, for each scheme's design model."""
    (_, name, kw), = [s for s in _specs() if s[0] == label]
    rs, ps = rc.make_scheme(name, N, 30, **kw), tc.make_scheme(name, N, 30, **kw)
    rgate, pgate = rc.ConformanceGate(rs.design_model, N), tc.ConformanceGate(ps.design_model, N)
    times_all = rc.GilbertElliotSource(n=N, p_ns=0.15, seed=5).sample_delays(60)
    for times in times_all:
        cand = times > 2.0 * times.min()
        if not cand.any():
            rgate.force(cand)
            pgate.force(cand)
            continue
        (rc_, rw), (pc_, pw) = rgate.admit_partial(cand, times), pgate.admit_partial(cand, times)
        np.testing.assert_array_equal(pc_, rc_)
        assert pw == rw
        assert pgate.alive == rgate.alive
    np.testing.assert_array_equal(pgate.history, rgate.history)


def test_window_models_batched_verdicts_equal_the_reference(rc):
    from repro.core import straggler as rst

    rng = np.random.default_rng(4)
    win = rng.random((64, 4, N)) < 0.2
    pairs = [
        (rst.PerRoundModel(2), tst.PerRoundModel(2)),
        (rst.BurstyModel(2, 4, 3), tst.BurstyModel(2, 4, 3)),
        (rst.ArbitraryModel(2, 4, 3), tst.ArbitraryModel(2, 4, 3)),
        (rst.RepCoverageModel(N, 1), tst.RepCoverageModel(N, 1)),
        (rst.WindowwiseOr((rst.BurstyModel(1, 4, 3), rst.PerRoundModel(1)), 4),
         tst.WindowwiseOr((tst.BurstyModel(1, 4, 3), tst.PerRoundModel(1)), 4)),
    ]
    for want, got in pairs:
        np.testing.assert_array_equal(got.suffix_ok_batch(torch.from_numpy(win)).numpy(),
                                      want.suffix_ok_batch(win))
        for w in win[:16]:
            assert got.conforms(w) == want.conforms(w)
            assert got.suffix_ok(w) == want.suffix_ok(w)


@pytest.mark.parametrize("label", SPEC_LABELS)
def test_scheme_decodes_equal_the_reference(rc, label):
    """Drive both packages through one conforming pattern, as
    tests/test_coded_master.py does, and compare every decode exactly."""
    from repro.core.executor import conforming_pattern

    (_, name, kw), = [s for s in _specs() if s[0] == label]
    jobs = 12
    rs, ps = rc.make_scheme(name, N, jobs, **kw), tc.make_scheme(name, N, jobs, **kw)
    assert (ps.T, ps.normalized_load, ps.chunk_grid()) == (rs.T, rs.normalized_load,
                                                          rs.chunk_grid())
    rounds = jobs + rs.T
    pat = conforming_pattern(rs.design_model, rounds, N, seed=3, density=0.3)
    seen = 0
    for t in range(1, rounds + 1):
        rs.step(t, pat[t - 1])
        ps.step(t, pat[t - 1])
        want, got = rs.collect_decodes(t), ps.collect_decodes(t)
        assert [_decode_tuple(j) for j in got] == [_decode_tuple(j) for j in want]
        for gj, wj in zip(got, want):
            np.testing.assert_array_equal(ps.chunk_slots(gj.job), rs.chunk_slots(wj.job))
            np.testing.assert_array_equal(ps.decode_weights(gj), rs.decode_weights(wj))
            seen += 1
    assert seen == jobs


@pytest.mark.parametrize("label", SPEC_LABELS)
def test_scheme_task_tables_equal_the_reference(rc, label):
    """The descriptor route itself: assign / observe / collect, round by round."""
    from repro.core.executor import conforming_pattern

    (_, name, kw), = [s for s in _specs() if s[0] == label]
    jobs = 8
    rs, ps = rc.make_scheme(name, N, jobs, **kw), tc.make_scheme(name, N, jobs, **kw)
    pat = conforming_pattern(rs.design_model, jobs + rs.T, N, seed=9, density=0.3)
    for t in range(1, jobs + rs.T + 1):
        want, got = rs.assign(t), ps.assign(t)
        assert [dataclasses.astuple(m) for m in got] == [dataclasses.astuple(m) for m in want]
        rs.observe(t, pat[t - 1])
        ps.observe(t, pat[t - 1])
        assert [_decode_tuple(j) for j in ps.collect(t)] == \
            [_decode_tuple(j) for j in rs.collect(t)]


def test_make_scheme_names_and_errors():
    assert tc.make_scheme("M_SGC", 8, 4, B=1, W=2, lam=2).name == "m-sgc"
    assert tc.make_scheme("none", 8, 4).name == "uncoded"
    with pytest.raises(ValueError, match="unknown scheme"):
        tc.make_scheme("dc-gc", 8, 4)
