"""The port's protocol executor (``repro_torch.core.executor``) against the
JAX package's: ``run_protocol``, ``decode_from_results`` and
``conforming_pattern`` are numpy over the schemes' bookkeeping, so the
contract is exact, bit for bit, over every scheme the harness runs."""

import numpy as np
import pytest

import repro_torch.core as tc
from repro_torch.core import executor as tex

SCHEMES = [
    ("gc", 4, {"s": 1}),
    ("gc", 6, {"s": 2, "prefer_rep": False}),
    ("sr-sgc", 4, {"B": 1, "W": 3, "lam": 3}),
    ("m-sgc", 4, {"B": 1, "W": 3, "lam": 4}),
    ("m-sgc", 6, {"B": 2, "W": 3, "lam": 3}),
    ("dc-gc", 8, {"C": 4, "s": 1}),
    ("sb-gc", 8, {"C": 4, "s": 1}),
    ("uncoded", 4, {}),
]
J = 6


@pytest.fixture(scope="module")
def ref():
    import repro.core as rc
    from repro.core import executor as rex

    return rc, rex


def _ids(s):
    return f"{s[0]}-n{s[1]}-" + "-".join(f"{k}{v}" for k, v in s[2].items())


@pytest.mark.parametrize("spec", SCHEMES, ids=[_ids(s) for s in SCHEMES])
@pytest.mark.parametrize("seed", [0, 3])
def test_conforming_pattern_and_run_protocol_equal_the_reference(ref, spec, seed):
    rc, rex = ref
    name, n, params = spec
    want_sch = rc.make_scheme(name, n, J, **params)
    got_sch = tc.make_scheme(name, n, J, **params)
    rounds = J + want_sch.T
    want_pat = rex.conforming_pattern(want_sch.design_model, rounds, n, seed=seed)
    got_pat = tex.conforming_pattern(got_sch.design_model, rounds, n, seed=seed)
    np.testing.assert_array_equal(got_pat, want_pat)
    want = rex.run_protocol(want_sch, want_pat, dim=5, seed=seed)
    got = tex.run_protocol(got_sch, got_pat, dim=5, seed=seed)
    assert sorted(got) == sorted(want) == list(range(1, J + 1))
    for j in want:
        assert got[j].dtype == want[j].dtype
        np.testing.assert_array_equal(got[j], want[j])


@pytest.mark.parametrize("spec", SCHEMES, ids=[_ids(s) for s in SCHEMES])
def test_decode_from_results_equals_the_reference(ref, spec):
    """The master's decode over one shared results table, job by job, with
    the job-id override the elastic master's degraded epochs use."""
    rc, rex = ref
    name, n, params = spec
    want_sch = rc.make_scheme(name, n, J, **params)
    got_sch = tc.make_scheme(name, n, J, **params)
    rounds = J + want_sch.T
    pat = rex.conforming_pattern(want_sch.design_model, rounds, n, seed=5)
    rng = np.random.default_rng(11)
    results = {}
    for t in range(1, rounds + 1):
        tasks = want_sch.assign(t)
        got_sch.assign(t)
        for mt in tasks:
            if mt.trivial:
                continue
            key = {"ell": ("ell", mt.job, mt.worker), "d1": ("d1", mt.job, mt.chunk),
                   "all": ("d1", mt.job, mt.chunk),
                   "d2": ("d2", mt.job, mt.chunk, mt.worker)}[mt.kind]
            results.setdefault(key, rng.standard_normal(7))
            if key[0] == "ell":
                results.setdefault(("ell", mt.job + 100, mt.worker), rng.standard_normal(7))
        want_sch.observe(t, pat[t - 1])
        got_sch.observe(t, pat[t - 1])
        want_jds, got_jds = want_sch.collect(t), got_sch.collect(t)
        assert [jd.job for jd in got_jds] == [jd.job for jd in want_jds]
        for wjd, gjd in zip(want_jds, got_jds):
            np.testing.assert_array_equal(
                tex.decode_from_results(got_sch, gjd, results),
                rex.decode_from_results(want_sch, wjd, results))
            if wjd.ell_weights:
                np.testing.assert_array_equal(
                    tex.decode_from_results(got_sch, gjd, results, job=gjd.job + 100),
                    rex.decode_from_results(want_sch, wjd, results, job=wjd.job + 100))
