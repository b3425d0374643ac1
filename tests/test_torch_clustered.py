"""The port's clustered GC baselines (dc-gc, sb-gc) against the JAX package's.

The cluster code, the cluster models, the schemes and their lockstep kernels
are held to the reference's numpy engine (its staged JAX engine does not run
on the installed JAX): exact on codes, decodes, gate verdicts and every
``SimResult`` (``assert_sim_parity(exact=True)``), on the CPU.  The trainers'
decoded gradients are held to the full-batch gradient at
``tests/test_coded_master.py``'s tolerance and their simulated clocks to the
reference's exactly.  The ``cuda``-marked tests hold the card's lockstep run
to the CPU's.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core import straggler as tst
from repro_torch.kernels.gate_window import gate_window as gw_kernel
from repro_torch.kernels.gate_window import ref as gw_ref

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
GE = dict(p_ns=0.08, p_sn=0.6, slow_factor=6.0)       # tests/test_lockstep.py
GE_SC = dict(p_ns=0.10, p_sn=0.5, slow_factor=6.0)    # tests/test_scenarios.py
GRAD_TOL = dict(atol=2e-5, rtol=2e-3)                 # tests/test_coded_master.py
# tests/test_lockstep.py's CONFIGS of the clustered baselines (n = 12)
CONFIGS = [
    ("dc-gc", dict(C=3, s=2)),
    ("dc-gc", dict(C=4, s=1)),
    ("sb-gc", dict(C=3, s=2)),
    ("sb-gc", dict(C=2, s=3)),
]
IDS = [f"{n}-{kw['C']}-{kw['s']}" for n, kw in CONFIGS]


@pytest.fixture(scope="module")
def rc():
    """The JAX package's ``repro.core`` (its numpy engine)."""
    import repro.core

    return repro.core


@pytest.fixture(scope="module")
def parity():
    from repro.core.testing import assert_sim_parity

    return assert_sim_parity


def _traces(n, rounds, num, seed0=0, ge=GE):
    return np.stack([tst.GilbertElliotSource(n=n, seed=seed0 + k, **ge).sample_delays(rounds)
                     for k in range(num)])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _scheme_grid(n):
    sys.path.insert(0, str(ROOT))  # examples/ lives at the repo root
    from examples.multimodel_training import scheme_grid

    return scheme_grid(n)


# -- the cluster code ------------------------------------------------------------------


def _clusterings(n, C, seed):
    rng = np.random.default_rng(seed)
    from repro.core.straggler import _round_robin_clusters as ref_deal

    perm = rng.permutation(n)
    blocks = np.empty(n, dtype=np.int64)
    blocks[perm] = np.arange(n) % C
    return [np.arange(n) % C, np.asarray(ref_deal(rng.random(n) < 0.3, C)), blocks]


@pytest.mark.parametrize("n,C,s,prefer_rep", [(12, 3, 1, True), (12, 2, 2, True),
                                              (12, 2, 2, False), (16, 4, 2, True),
                                              (16, 2, 0, True)])
def test_cluster_gradient_code_equals_the_reference(rc, n, C, s, prefer_rep):
    """Encode matrix, chunks, decode vectors and the DecodingError (naming the
    cluster) on the same survivors, bit for bit."""
    from repro.core.gc import ClusterGradientCode as RefCode

    rng = np.random.default_rng(n * C + s)
    for cid in _clusterings(n, C, seed=s):
        want = RefCode(cid, s, prefer_rep=prefer_rep, seed=3)
        got = tc.ClusterGradientCode(cid, s, prefer_rep=prefer_rep, seed=3)
        assert (got.n, got.s, got.C, got.normalized_load) == (want.n, want.s, want.C,
                                                               want.normalized_load)
        assert type(got.inner).__name__ == type(want.inner).__name__
        np.testing.assert_array_equal(got.encode_matrix, want.encode_matrix)
        for i in range(n):
            np.testing.assert_array_equal(got.chunks_of_worker(i), want.chunks_of_worker(i))
        for _ in range(12):
            surv_mask = np.ones(n, dtype=bool)
            for c in range(C):  # lose up to s, sometimes s + 1, workers of each cluster
                members = np.flatnonzero(cid == c)
                k = rng.integers(0, s + 2 if rng.random() < 0.3 else s + 1)
                surv_mask[rng.choice(members, size=k, replace=False)] = False
            surv = np.flatnonzero(surv_mask).tolist()
            assert got.can_decode_mask(surv_mask) == want.can_decode_mask(surv_mask)
            try:
                beta = want.decode_vector(surv)
            except rc.gc.DecodingError as err:
                with pytest.raises(tc.DecodingError) as got_err:
                    got.decode_vector(surv)
                assert str(got_err.value) == str(err)
            else:
                np.testing.assert_array_equal(got.decode_vector(surv), beta)


def test_cluster_code_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError, match="equal-sized"):
        tc.ClusterGradientCode(np.array([0, 0, 1]), 0)
    with pytest.raises(ValueError, match="cluster size"):
        tc.ClusterGradientCode(np.arange(8) % 4, 2)


# -- the cluster models ------------------------------------------------------------------


def test_round_robin_deal_and_cluster_counts_equal_the_reference():
    """The cluster helpers on numpy arrays and on torch tensors."""
    from repro.core import straggler as rst

    rng = np.random.default_rng(0)
    prev = rng.random((6, 9, 12)) < 0.3
    for C in (1, 2, 3, 4, 6):
        want = rst._round_robin_clusters(prev, C)
        np.testing.assert_array_equal(tst._round_robin_clusters(prev, C), want)
        np.testing.assert_array_equal(tst._round_robin_clusters(_t(prev), C).numpy(), want)
        for s in (0, 1, 2):
            ok = rst._cluster_counts_ok(prev, want, C, s)
            np.testing.assert_array_equal(tst._cluster_counts_ok(prev, want, C, s), ok)
            np.testing.assert_array_equal(
                tst._cluster_counts_ok(_t(prev), _t(want), C, s).numpy(), ok)


def _model_pairs():
    from repro.core import straggler as rst

    blocks = tuple(int(b) for b in tc.make_scheme("sb-gc", 12, 4, C=3, s=1, seed=5).block_of)
    return {
        "dynamic-4-1": (rst.DynamicClusterModel(12, 4, 1), tst.DynamicClusterModel(12, 4, 1)),
        "dynamic-3-2": (rst.DynamicClusterModel(12, 3, 2), tst.DynamicClusterModel(12, 3, 2)),
        "dynamic-2-0": (rst.DynamicClusterModel(12, 2, 0), tst.DynamicClusterModel(12, 2, 0)),
        "block-3-1": (rst.StochasticBlockModel(12, 3, 1, blocks),
                      tst.StochasticBlockModel(12, 3, 1, blocks)),
    }


@pytest.mark.parametrize("label", list(_model_pairs()))
def test_cluster_model_hooks_equal_the_reference(label):
    """suffix_ok_batch, min_drops_batch, admit_fn_batch and
    drops_lower_bound_fn_batch on torch tensors, and conforms / suffix_ok on
    numpy, == the reference's numpy hooks, at every committed-buffer depth."""
    n, cells = 12, 64
    want, got = _model_pairs()[label]
    assert got.window == want.window and not got.column_reducible
    rng = np.random.default_rng(sum(map(ord, label)))
    for kh in range(want.window):
        buf = rng.random((cells, kh, n)) < 0.3
        cand = rng.random((cells, n)) < rng.uniform(0.1, 0.6)
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
        for c in range(8):
            assert got.suffix_ok(win[c]) == want.suffix_ok(win[c])
            assert got.conforms(win[c]) == want.conforms(win[c])
    pattern = rng.random((30, n)) < 0.15
    assert got.conforms(pattern) == want.conforms(pattern)
    gate_t, gate_r = tst.ConformanceGate(got, n), rc_gate(want, n)
    for row in pattern:
        assert gate_t.admit(row.copy()) == gate_r.admit(row.copy())


def rc_gate(model, n):
    from repro.core.straggler import ConformanceGate

    return ConformanceGate(model, n)


# -- schemes: decodes, against the reference's collect_decodes and collect ---------------


def _jd_key(jd):
    return (jd.job, jd.round_done, tuple(sorted(jd.ell_weights.items())))


@pytest.mark.parametrize("name", ["dc-gc", "sb-gc"])
def test_clustered_decodes_equal_the_reference_on_the_trace_library(rc, name):
    """tests/test_decode_consistency.py's replay: each scenario's admitted
    pattern through the port's step / collect_decodes, the reference's
    collect_decodes (its kernel route) and its descriptor collect — the same
    JobDecodes, chunk slots and decode weights, bit for bit."""
    n, J, kw = 16, 16, dict(C=4, s=1)
    for sc in tc.trace_library(n=n, rounds=20, num_traces=1, seed=0):
        pattern = rc.simulate(rc.make_scheme(name, n, J, **kw), sc.delays[0], mu=1.0,
                              alpha=sc.alpha, J=J).effective_pattern
        fast, desc = rc.make_scheme(name, n, J, **kw), rc.make_scheme(name, n, J, **kw)
        got = tc.make_scheme(name, n, J, **kw)
        seen = 0
        for t in range(1, pattern.shape[0] + 1):
            fast.step(t, pattern[t - 1])
            desc.assign(t)
            desc.observe(t, pattern[t - 1])
            got.step(t, pattern[t - 1])
            want = fast.collect_decodes(t)
            have = got.collect_decodes(t)
            assert [_jd_key(j) for j in have] == [_jd_key(j) for j in want], sc.name
            assert [_jd_key(j) for j in desc.collect(t)] == [_jd_key(j) for j in want]
            for g, w in zip(have, want):
                np.testing.assert_array_equal(got.chunk_slots(g.job), fast.chunk_slots(w.job))
                np.testing.assert_array_equal(got.decode_weights(g), fast.decode_weights(w))
                np.testing.assert_array_equal(got.code.encode_matrix, desc.code.encode_matrix)
                seen += 1
        assert seen == J, sc.name


def test_clustered_scheme_tables_and_errors(rc):
    """assign's task table, the seed's block draw, the wait-out contract's
    AssertionError, and the clustering read before any assign."""
    n = 12
    for name, kw in CONFIGS:
        want, got = rc.make_scheme(name, n, 6, seed=4, **kw), tc.make_scheme(name, n, 6, seed=4,
                                                                            **kw)
        assert (got.T, got.normalized_load, got.chunk_grid()) == (want.T, want.normalized_load,
                                                                  want.chunk_grid())
        assert repr(got.design_model) == repr(want.design_model)
        assert [m.kind for m in got.assign(1)] == [m.kind for m in want.assign(1)]
        assert [m.kind for m in got.assign(7)] == ["none"] * n
    np.testing.assert_array_equal(tc.make_scheme("sb-gc", n, 4, C=3, s=1, seed=9).block_of,
                                  rc.make_scheme("sb-gc", n, 4, C=3, s=1, seed=9).block_of)
    with pytest.raises(KeyError, match="never assigned"):
        tc.make_scheme("dc-gc", n, 4, C=3, s=1).code
    sch = tc.make_scheme("dc-gc", n, 4, C=3, s=1)
    sch.assign(1)
    row = np.zeros(n, dtype=bool)
    row[[0, 3]] = True    # both in cluster 0 of the identity layout: 2 > s
    sch.observe(1, row)
    with pytest.raises(AssertionError, match="cluster 0 kept 2 of 4"):
        sch.collect(1)
    for bad in (dict(C=5, s=1), dict(C=3, s=4), dict(C=0, s=0)):
        with pytest.raises(ValueError):
            tc.make_scheme("dc-gc", n, 4, **bad)


# -- the simulator ------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", CONFIGS, ids=IDS)
@pytest.mark.parametrize("waitout", ["selective", "all"])
def test_clustered_lockstep_matches_the_numpy_engine(rc, parity, name, kw, waitout):
    """tests/test_lockstep.py's clustered configs: the port's lockstep engine,
    its scalar simulate_fast and its descriptor simulate, each against the
    reference's, bit for bit."""
    n, J, cells = 12, 20, 3
    traces = _traces(n, 26, cells, seed0=20)
    want = rc.simulate_lockstep(name, kw, traces, alpha=6.0, J=J, waitout=waitout)
    got = tc.simulate_lockstep(name, kw, traces, alpha=6.0, J=J, waitout=waitout, device=CPU)
    assert len(got) == cells
    for w, g in zip(want, got):
        parity(w, g, exact=True)
    for sim_t, sim_r in ((tc.simulate, rc.simulate), (tc.simulate_fast, rc.simulate_fast)):
        g = sim_t(tc.make_scheme(name, n, J, **kw), traces[0], alpha=6.0, J=J, waitout=waitout)
        w = sim_r(rc.make_scheme(name, n, J, **kw), traces[0], alpha=6.0, J=J, waitout=waitout)
        parity(w, g, exact=True)


def test_clustered_per_worker_alpha_bit_for_bit(rc, parity):
    """tests/test_scenarios.py's heterogeneous alpha: a per-worker (n,) alpha
    through simulate, simulate_fast and the lockstep engine."""
    n, J = 12, 14
    alpha = tc.LambdaTraceGenerator(n=n, seed=1, hetero=0.4).worker_alpha()
    traces = np.stack([tc.LambdaTraceGenerator(n=n, seed=1 + k, hetero=0.4, speed_seed=3)
                       .sample_delays(J + 4) for k in range(2)])
    for name, kw in [("dc-gc", dict(C=4, s=1)), ("sb-gc", dict(C=3, s=1))]:
        lock = tc.simulate_lockstep(name, kw, traces, alpha=alpha, J=J, device=CPU)
        for c in range(2):
            want = rc.simulate(rc.make_scheme(name, n, J, **kw), traces[c], alpha=alpha, J=J)
            for got in (tc.simulate(tc.make_scheme(name, n, J, **kw), traces[c], alpha=alpha,
                                    J=J),
                        tc.simulate_fast(tc.make_scheme(name, n, J, **kw), traces[c],
                                         alpha=alpha, J=J),
                        lock[c]):
                parity(want, got, exact=True)


def test_sbgc_seed_axis_fans_out(rc, parity):
    """sb-gc is seed-sensitive: simulate_batch runs each seed (distinct
    results, distinct block draws), every cell equal to the reference's
    scalar run with that seed."""
    n, num_traces = 12, 2
    seeds = tuple(range(5))
    traces = _traces(n, 14, num_traces, seed0=31, ge=GE_SC)
    kw = {"C": 3, "s": 1}
    grid = tc.simulate_batch([("sb-gc", kw)], traces, seeds=seeds, alpha=6.0, J=12, device=CPU)
    assert grid.shape == (1, len(seeds), num_traces)
    assert tc.kernel_seed_sensitive("sb-gc") and not tc.kernel_seed_sensitive("dc-gc")
    for ki, seed in enumerate(seeds):
        for ti in range(num_traces):
            r = grid[0, ki, ti]
            assert r is not grid[0, 0, ti] or ki == 0
            want = rc.simulate_fast(rc.make_scheme("sb-gc", n, 12, seed=seed, **kw),
                                    traces[ti], alpha=6.0, J=12)
            parity(want, r, exact=True)
    totals = {round(grid[0, ki, ti].total_time, 9)
              for ki in range(len(seeds)) for ti in range(num_traces)}
    assert len(totals) > num_traces


@pytest.mark.parametrize("waitout", ["selective", "all"])
def test_clustered_baselines_dominate_gc_at_equal_load(waitout):
    """At equal load the clustered baselines admit a superset of general GC's
    patterns, so no round of theirs is longer and they wait out no more."""
    n, J, s = 12, 16, 2
    traces = _traces(n, J, 3, seed0=41, ge=GE_SC)
    gc = tc.simulate_lockstep("gc", {"s": s, "prefer_rep": False}, traces, alpha=6.0, J=J,
                              waitout=waitout, device=CPU)
    for name in ("dc-gc", "sb-gc"):
        got = tc.simulate_lockstep(name, {"C": 4, "s": s}, traces, alpha=6.0, J=J,
                                   waitout=waitout, device=CPU)
        for a, b in zip(gc, got):
            assert b.normalized_load == a.normalized_load
            assert b.waitouts <= a.waitouts
            assert (b.round_times <= a.round_times + 1e-9).all()
            assert b.total_time <= a.total_time + 1e-9


def test_every_scheme_of_the_grid_has_a_kernel_grid_and_delay(rc):
    from repro.core import simulator as rsim

    for n in (8, 12, 16, 256):
        for label, name, kw in _scheme_grid(n):
            assert tc.has_kernel(name), label
            assert tc.make_scheme(name, n, 4, **kw).name == rc.make_scheme(name, n, 4, **kw).name
    for name in ("gc", "sr-sgc", "m-sgc", "dc-gc", "sb-gc", "uncoded"):
        for n in (12, 16):
            assert tc.default_grid(name, n) == rsim.default_grid(name, n)
            for params in tc.default_grid(name, n):
                assert tc.params_delay(name, params) == rsim.params_delay(name, params)
    assert tc.params_delay("DC_GC", {"C": 2, "s": 1}) == 0


def test_select_parameters_over_the_clustered_grids(rc):
    n = 12
    probe = tst.GilbertElliotSource(n=n, seed=4, p_ns=0.1, p_sn=0.5,
                                    slow_factor=6.0).sample_delays(20)
    for name in ("dc-gc", "sb-gc"):
        want = rc.select_parameters(name, n, probe, alpha=6.0)
        got = tc.select_parameters(name, n, probe, alpha=6.0, device=CPU)
        assert (got.params, got.load) == (want.params, want.load)
        assert np.isclose(got.est_time, want.est_time)


# -- the trainers ------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [("dc-gc", dict(C=2, s=3)), ("sb-gc", dict(C=2, s=3)),
                                     ("dc-gc", dict(C=4, s=1))])
def test_coded_training_driver_decodes_the_full_batch_gradient(rc, name, kw):
    """tests/test_coded_master.py's contract through the descriptor driver:
    every decoded gradient (coded_combine of the survivors' encodes) equals
    the full-batch gradient, and the simulated clock equals the reference's."""
    from repro.train import CodedTrainingDriver as RefDriver

    from repro_torch.launch.train import check_decodes_of
    from repro_torch.train import CodedTrainingDriver

    n, J = 8, 6
    delays = tc.GilbertElliotSource(n=n, seed=7, p_ns=0.2, p_sn=0.5,
                                    slow_factor=6.0).sample_delays(J + 4)
    drv = CodedTrainingDriver(scheme=tc.make_scheme(name, n, J, **kw), num_models=2,
                              batch_size=64, lr=5e-3, seed=3, device=CPU)
    worst, grads = check_decodes_of(drv), []
    decode = drv.decode_gradient

    def kept(jd):
        grads.append((jd.job, decode(jd)))
        return grads[-1][1]

    drv.decode_gradient = kept
    clock = drv.run(J, delays)
    ref = RefDriver(scheme=rc.make_scheme(name, n, J, **kw), num_models=2, batch_size=64,
                    lr=5e-3, seed=3)
    assert clock == ref.run(J, delays)
    assert drv.job_done_time == ref.job_done_time
    assert drv.compute_units == pytest.approx(ref.compute_units, rel=1e-12)
    assert len(worst) == J and drv.encodes > 0
    for job, got in grads[::2]:   # each job decoded twice: checked, then applied
        want = drv.full_gradient(job)
        for k in want:
            torch.testing.assert_close(got[k], want[k], **GRAD_TOL)
    assert all(np.isfinite(drv.losses[m]).all() for m in range(2))


@pytest.mark.parametrize("name", ["dc-gc", "sb-gc"])
def test_coded_step_gradient_exact(rc, name):
    """The coded step's weighted loss decodes the full-batch gradient under a
    conforming pattern (per-chunk weights sum to 1, straggler rows zero)."""
    from repro.core.executor import conforming_pattern

    from repro_torch.configs import get_smoke
    from repro_torch.data import coded_slot_batch, token_batch
    from repro_torch.models import init_params, loss_fn
    from repro_torch.train.coded import coded_loss, value_and_grad
    from repro_torch.tree import tree_leaves

    n, jobs, kw = 8, 2, dict(C=2, s=3)
    sch = tc.make_scheme(name, n, jobs + 4, **kw)
    pat = conforming_pattern(rc.make_scheme(name, n, jobs + 4, **kw).design_model, jobs + 2, n,
                             seed=3, density=0.3)
    cfg = get_smoke("qwen2-0.5b").replace(num_layers=1, d_model=64, num_heads=2, num_kv_heads=1,
                                          head_dim=32, d_ff=128, vocab_size=128)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    num_chunks, _ = sch.chunk_grid()
    for t in range(1, jobs + 1):
        sch.step(t, pat[t - 1])
        (jd,) = sch.collect_decodes(t)
        slot_map, w = sch.chunk_slots(t), sch.decode_weights(jd)
        acc = np.zeros(num_chunks)
        np.add.at(acc, slot_map.ravel(), w.ravel().astype(np.float64))
        np.testing.assert_allclose(acc, 1.0, atol=1e-5)
        assert (w[pat[t - 1]] == 0).all()
        batch = token_batch(0, t, 32, 16, cfg.vocab_size, device=CPU)
        coded = coded_slot_batch(batch, slot_map, num_chunks)
        _, full = value_and_grad(lambda p: loss_fn(p, cfg, batch, aux_weight=0.0), params)
        _, got = value_and_grad(lambda p: coded_loss(p, cfg, coded, torch.from_numpy(w),
                                                     num_chunks), params)
        for a, b in zip(tree_leaves(got), tree_leaves(full)):
            torch.testing.assert_close(a, b, **GRAD_TOL)


def test_vectorized_trainer_clocks_equal_the_reference(rc):
    """bench_coded_train's tiny config: the port's VectorizedCodedTrainer and
    the reference's give the same simulated clocks for dc-gc and sb-gc on
    ge-bursty (the port's training runs; the reference's coded steps are
    skipped, since the clock is framework-free)."""
    from repro.configs.qwen2_0_5b import SMOKE
    from repro.train import VectorizedCodedTrainer as RefTrainer

    from repro_torch.launch.scenarios import scheme_grid, tiny_config
    from repro_torch.train import VectorizedCodedTrainer

    n, jobs = 8, 6
    sc = tc.trace_library(n=n, rounds=jobs + 8, num_traces=1, seed=0)[0]
    assert sc.name == "ge-bursty"
    jcfg = SMOKE.replace(num_layers=1, d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
                         d_ff=128, vocab_size=128)
    for label, name, kw in scheme_grid(n):
        if name not in ("dc-gc", "sb-gc"):
            continue
        common = dict(num_models=2, batch_size=32, seq_len=8, lr=1e-3, mu=1.0,
                      alpha=float(np.mean(sc.alpha)), seed=0)
        got = VectorizedCodedTrainer(scheme=tc.make_scheme(name, n, jobs, **kw),
                                     cfg=tiny_config(), device=CPU, **common)
        want = RefTrainer(scheme=rc.make_scheme(name, n, jobs, **kw), cfg=jcfg, **common)
        want._apply = lambda jd: None   # its clock never reads the numerics
        assert got.run(jobs, sc.delays[0]) == want.run(jobs, sc.delays[0]), label
        assert got.job_done_time == want.job_done_time
        assert all(np.isfinite(got.losses[m]).all() for m in range(2))


# -- on the card ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", CONFIGS + [("dc-gc", dict(C=4, s=8)),
                                               ("sb-gc", dict(C=4, s=8))])
@pytest.mark.parametrize("waitout", ["selective", "all"])
def test_clustered_lockstep_on_the_card_matches_the_cpu(cuda_device, name, kw, waitout):
    """The card's run equals the CPU's under the device contract; the gate's
    window-statistics kernels launch exactly as often as the CPU run calls
    their plain versions (the cluster models need none)."""
    n = 12 if kw["s"] < 8 else 64
    traces = _traces(n, 26, 16, seed0=70)
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
