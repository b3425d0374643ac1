"""The port's coded-training slice against the JAX package.

On the CPU, in f32, from the same numpy inputs and converted parameters:
AdamW, the data plumbing, ``loss_fn`` and its gradients, the coded train
step (the exactness contract of ``tests/test_coded_master.py``: per-chunk
weights sum to 1, straggler rows are zero, coded gradient == full-batch
gradient, step loss == full-batch loss) for the paper's schemes (the
clustered baselines' are in ``tests/test_torch_clustered.py``),
both drivers, and the ``launch.train`` entry points.  On the card
(``-m cuda``): the coded step through the kernels against the plain path,
and the demo driver's ``coded_combine`` launches.

Tolerances: f32 sums taken in other orders agree to ~1e-6 relative, so
values are held at 1e-5 and gradients (sums over a whole batch) at
``tests/test_coded_master.py``'s atol 2e-5 / rtol 2e-3.  Losses after
AdamW updates are held at 1e-3: Adam's first steps move every parameter by
about lr whatever the gradient's size, so sub-1e-6 differences in tiny
gradient entries become lr-sized parameter differences
(``tests/test_coded_master.py``'s note).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
from repro_torch.convert import adamw_state_from_jax, mlp_params_from_jax, params_from_jax
from repro_torch.core import GilbertElliotSource, make_gradient_code, make_scheme
from repro_torch.data import (
    chunk_boundaries,
    classification_batch,
    coded_slot_batch,
    gc_chunked_batch,
    token_batch,
)
from repro_torch.launch.train import train_arch, train_demo
from repro_torch.models import loss_fn
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
from repro_torch.train import (
    CodedTrainingDriver,
    VectorizedCodedTrainer,
    chunk_loss_sum,
    gc_round_weights,
    make_coded_train_step,
)
from repro_torch.train.coded import coded_loss, value_and_grad
from repro_torch.tree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2-0.5b"
N, JOBS, BATCH, SEQ = 8, 2, 32, 16
GRAD_TOL = dict(atol=2e-5, rtol=2e-3)      # tests/test_coded_master.py
VALUE_TOL = dict(atol=1e-5, rtol=1e-5)
SPEC_LABELS = ("m-sgc", "sr-sgc", "gc-rep", "gc", "uncoded")
PER_ROUND = {"gc-rep", "gc"}  # job-t decodes from round t's survivors alone


def _tiny(cfg):
    """tests/test_coded_master.py's one-layer config."""
    return cfg.replace(num_layers=1, d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
                       d_ff=128, vocab_size=128)


def _specs():
    sys.path.insert(0, str(ROOT))  # examples/ lives at the repo root
    from examples.multimodel_training import scheme_grid

    return [s for s in scheme_grid(N) if s[0] in SPEC_LABELS]


@pytest.fixture(scope="module")
def ref():
    """(jax, jax.numpy, the JAX package's modules by name)."""
    import jax
    import jax.numpy as jnp

    import repro.configs
    import repro.core
    import repro.data
    import repro.models
    import repro.optim
    import repro.train
    import repro.train.coded

    return jax, jnp, {"configs": repro.configs, "core": repro.core, "data": repro.data,
                      "models": repro.models, "optim": repro.optim, "train": repro.train,
                      "coded": repro.train.coded}


def _np_tree(jax, tree):
    return jax.tree.map(np.asarray, tree)


def _close_trees(got, want_np, **tol):
    """got: a port tree; want_np: the reference tree as numpy, in port layout."""
    g, w = tree_leaves(got), tree_leaves(want_np)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.detach().float().numpy(), np.asarray(b, np.float32), **tol)


def _port_layout(tree_np, cfg):
    """The reference's stacked-layer numpy tree as the port lays it out."""
    return params_from_jax(tree_np, cfg, device="cpu", dtype=torch.float32)


# -- optimizer -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_three_steps_match_reference(ref, dtype):
    jax, jnp, r = ref
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (5,), "c": {"d": (3, 4, 2)}}
    p_np = tree_map(lambda s: rng.standard_normal(s).astype(np.float32), shapes)
    grads = [tree_map(lambda s: rng.standard_normal(s).astype(np.float32), shapes)
             for _ in range(3)]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p_np)
    tp = tree_map(lambda a: torch.from_numpy(a).to(tdt), p_np)
    js, ts = r["optim"].adamw_init(jp), adamw_init(tp)
    for g in grads:
        jp, js = r["optim"].adamw_update(jp, jax.tree.map(lambda a: jnp.asarray(a, jdt), g), js,
                                         lr=1e-2, weight_decay=0.1)
        tp, ts = adamw_update(tp, tree_map(lambda a: torch.from_numpy(a).to(tdt), g), ts,
                              lr=1e-2, weight_decay=0.1)
    assert ts.step == int(js.step) == 3
    assert all(p.dtype == tdt for p in tree_leaves(tp))
    assert all(m.dtype == torch.float32 for m in tree_leaves(ts.m) + tree_leaves(ts.v))
    # bf16 parameters round once per step: allow one bf16 ulp (2**-8 relative)
    ptol = VALUE_TOL if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    _close_trees(tp, _np_tree(jax, jax.tree.map(lambda a: a.astype(jnp.float32), jp)), **ptol)
    _close_trees(ts.m, _np_tree(jax, js.m), **VALUE_TOL)
    _close_trees(ts.v, _np_tree(jax, js.v), **VALUE_TOL)


def test_cosine_schedule_matches_reference(ref):
    r = ref[2]
    want, got = r["optim"].cosine_schedule(3e-4, 10, 100), cosine_schedule(3e-4, 10, 100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        # the reference rounds in f32: 1 + cos near the end loses ~1e-7 of base_lr
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6, abs=3e-4 * 1e-6)


def test_adamw_state_converts_from_reference(ref):
    jax, jnp, r = ref
    cfg = _tiny(tcfgs.get_smoke(ARCH))
    jparams = r["models"].init_params(_tiny(r["configs"].get_smoke(ARCH)), jax.random.PRNGKey(0))
    st = r["optim"].adamw_init(jparams)
    st = st._replace(m=jax.tree.map(lambda a: a + 1.0, st.m))
    got = adamw_state_from_jax(_np_tree(jax, st), cfg, device="cpu")
    assert got.step == 0 and len(got.m["layers"]) == cfg.num_layers
    assert all(float(m.min()) == 1.0 and m.dtype == torch.float32 for m in tree_leaves(got.m))
    assert all(float(v.abs().max()) == 0.0 for v in tree_leaves(got.v))


# -- data ------------------------------------------------------------------------


def test_classification_batch_and_chunks_exact(ref):
    r = ref[2]
    for seed, job in ((0, 1), (3, 17)):
        jx, jy = r["data"].classification_batch(seed, job, 96, 64, 10)
        tx, ty = classification_batch(seed, job, 96, 64, 10)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    sch = make_scheme("m-sgc", 12, 4, B=1, W=2, lam=4)
    for d, fr in ((256, [1 / 16] * 16), (96, [sch.chunk_fraction(c) for c in
                                              range(sch.num_chunks)]), (10, [0.5, 0.3, 0.2])):
        assert chunk_boundaries(d, fr) == r["data"].chunk_boundaries(d, fr)


def test_chunked_batches_exact(ref):
    jax, jnp, r = ref
    batch = r["data"].token_batch(0, 3, BATCH, SEQ, 128)
    tb = {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}
    for k, v in r["data"].gc_chunked_batch(batch, N, 3).items():
        np.testing.assert_array_equal(gc_chunked_batch(tb, N, 3)[k].numpy(), np.asarray(v))
    sch = make_scheme("m-sgc", N, 4, B=1, W=2, lam=2)
    nc, _ = sch.chunk_grid()
    want = r["data"].coded_slot_batch(batch, sch.chunk_slots(1), nc)
    got = coded_slot_batch(tb, sch.chunk_slots(1), nc)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError, match="divisible"):
        coded_slot_batch(tb, sch.chunk_slots(1), 5)


def test_token_batch_is_deterministic_with_labels_equal_to_tokens():
    a, b = token_batch(0, 4, 6, 9, 50), token_batch(0, 4, 6, 9, 50)
    assert a["tokens"].shape == (6, 9) and a["tokens"].dtype == torch.int64
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["labels"], a["tokens"])
    assert 0 <= int(a["tokens"].min()) and int(a["tokens"].max()) < 50
    assert not torch.equal(a["tokens"], token_batch(0, 5, 6, 9, 50)["tokens"])


# -- the model's loss and gradients ------------------------------------------------


def test_loss_and_gradients_match_reference(ref):
    """SMOKE in f32 from converted parameters: loss_fn and its gradient."""
    jax, jnp, r = ref
    jcfg, tcfg = r["configs"].get_smoke(ARCH), tcfgs.get_smoke(ARCH)
    jparams = r["models"].init_params(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(_np_tree(jax, jparams), tcfg, device="cpu")
    batch = r["data"].token_batch(0, 1, 4, 24, jcfg.vocab_size)
    tb = {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}
    want_loss, want_grad = jax.jit(jax.value_and_grad(
        lambda p: r["models"].loss_fn(p, jcfg, batch, aux_weight=0.0)))(jparams)
    got_loss, got_grad = value_and_grad(lambda p: loss_fn(p, tcfg, tb, aux_weight=0.0),
                                        tparams)
    assert float(got_loss) == pytest.approx(float(want_loss), rel=1e-5)
    _close_trees(got_grad, _port_layout(_np_tree(jax, want_grad), tcfg), **GRAD_TOL)


# -- the coded step ------------------------------------------------------------------


def _drive(rc, label, name, kw, seed=3):
    """Step the port's scheme through a pattern conforming to the reference's
    design model; return it and {job: (JobDecode, straggler row at its decode)}."""
    from repro.core.executor import conforming_pattern

    sch = make_scheme(name, N, JOBS + 4, **kw)
    rounds = JOBS + sch.T + 2
    pat = conforming_pattern(rc.make_scheme(name, N, JOBS + 4, **kw).design_model, rounds, N,
                             seed=seed, density=0.3)
    jds = {}
    for t in range(1, rounds + 1):
        sch.step(t, pat[t - 1])
        for jd in sch.collect_decodes(t):
            jds[jd.job] = (jd, pat[jd.round_done - 1])
    assert set(range(1, JOBS + 1)) <= set(jds), label
    return sch, jds


@pytest.mark.parametrize("label", SPEC_LABELS)
def test_coded_step_gradient_exact(ref, label):
    """tests/test_coded_master.py's exactness contract on the port."""
    jax, jnp, r = ref
    (_, name, kw), = [s for s in _specs() if s[0] == label]
    sch, jds = _drive(r["core"], label, name, kw)
    num_chunks, _ = sch.chunk_grid()
    cfg = _tiny(tcfgs.get_smoke(ARCH))
    jcfg = _tiny(r["configs"].get_smoke(ARCH))
    params = params_from_jax(
        _np_tree(jax, r["models"].init_params(jcfg, jax.random.PRNGKey(0))), cfg, device="cpu")
    opt = adamw_init(params)
    step = make_coded_train_step(cfg, sch.n, getattr(sch, "s", 0), lr=1e-3,
                                 num_chunks=num_chunks)
    for job in range(1, JOBS + 1):
        jd, stragglers = jds[job]
        slot_map, w = sch.chunk_slots(job), sch.decode_weights(jd)
        acc = np.zeros(num_chunks)
        np.add.at(acc, slot_map.ravel(), w.ravel().astype(np.float64))
        np.testing.assert_allclose(acc, 1.0, atol=1e-5, err_msg=label)
        if label in PER_ROUND:
            assert (w[stragglers] == 0).all(), label
        for i in range(N):
            if not (i in jd.ell_weights or i in jd.d1_workers
                    or any(i in ws for ws in jd.group_weights.values())):
                assert (w[i] == 0).all(), (label, i)

        batch = {k: torch.tensor(np.asarray(v)) for k, v in
                 r["data"].token_batch(0, job, BATCH, SEQ, cfg.vocab_size).items()}
        coded = coded_slot_batch(batch, slot_map, num_chunks)
        wt = torch.from_numpy(w)
        full_loss, full = value_and_grad(lambda p: loss_fn(p, cfg, batch, aux_weight=0.0),
                                         params)
        _, got = value_and_grad(lambda p: coded_loss(p, cfg, coded, wt, num_chunks), params)
        for a, b in zip(tree_leaves(got), tree_leaves(full)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=label, **GRAD_TOL)
        before = tree_leaves(params)[0].clone()
        params, opt, metrics = step(params, opt, coded, wt)
        assert float(metrics["loss"]) == pytest.approx(float(full_loss), abs=1e-4)
        assert not torch.allclose(before, tree_leaves(params)[0]), label


def test_coded_gradient_matches_reference(ref):
    """One GC (8, 3) coded gradient of the port against the reference's, from
    the same parameters, batch and round weights."""
    jax, jnp, r = ref
    cfg, jcfg = _tiny(tcfgs.get_smoke(ARCH)), _tiny(r["configs"].get_smoke(ARCH))
    jparams = r["models"].init_params(jcfg, jax.random.PRNGKey(2))
    tparams = params_from_jax(_np_tree(jax, jparams), cfg, device="cpu")
    jcode = r["core"].make_gradient_code(N, 3, prefer_rep=False)
    tcode = make_gradient_code(N, 3, prefer_rep=False)
    surv = [0, 1, 3, 4, 6]
    jw, tw = r["coded"].gc_round_weights(jcode, surv), gc_round_weights(tcode, surv)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    batch = r["data"].token_batch(0, 5, BATCH, SEQ, cfg.vocab_size)
    jcoded = r["data"].gc_chunked_batch(batch, N, 3)

    def jloss(p):
        per = jax.vmap(jax.vmap(lambda ch, w: w * r["coded"].chunk_loss_sum(p, jcfg, ch)))(
            jcoded, jw)
        return per.sum() / BATCH

    want = jax.jit(jax.grad(jloss))(jparams)
    tcoded = gc_chunked_batch({k: torch.tensor(np.asarray(v)) for k, v in batch.items()},
                              N, 3)
    loss, got = value_and_grad(lambda p: coded_loss(p, cfg, tcoded, tw, N), tparams)
    _close_trees(got, _port_layout(_np_tree(jax, want), cfg), **GRAD_TOL)
    # the decode identity: the weighted chunk loss sums over num_chunks * chunk_bs
    sums = sum(float(tw[i, j]) * float(chunk_loss_sum(
        tparams, cfg, {k: v[i, j] for k, v in tcoded.items()})) for i in range(N)
        for j in range(4))
    assert float(loss) == pytest.approx(sums / BATCH, rel=1e-5)
    assert float(loss) == pytest.approx(float(jax.jit(jloss)(jparams)), rel=1e-5)


# -- the drivers --------------------------------------------------------------------


def _capture_decodes(drv):
    captured = {}
    apply_update = drv._apply_update

    def cap(jd):
        captured[jd.job] = drv.decode_gradient(jd)
        apply_update(jd)

    drv._apply_update = cap
    return captured


@pytest.mark.parametrize("name,kw", [("gc", dict(s=3)), ("sr-sgc", dict(B=1, W=2, lam=4)),
                                     ("m-sgc", dict(B=1, W=2, lam=2)), ("uncoded", {})])
def test_coded_training_driver_matches_reference(ref, name, kw):
    jax, jnp, r = ref
    J = 6
    delays = r["core"].GilbertElliotSource(n=N, seed=7).sample_delays(J + 4)
    rdrv = r["train"].CodedTrainingDriver(scheme=r["core"].make_scheme(name, N, J, **kw),
                                          num_models=2, batch_size=64, lr=5e-3, seed=3)
    tdrv = CodedTrainingDriver(scheme=make_scheme(name, N, J, **kw), num_models=2,
                               batch_size=64, lr=5e-3, seed=3, device="cpu")
    tdrv.params = [mlp_params_from_jax(_np_tree(jax, p), device="cpu") for p in rdrv.params]
    tdrv.opt = [adamw_init(p) for p in tdrv.params]
    rcap, tcap = _capture_decodes(rdrv), _capture_decodes(tdrv)
    assert tdrv.run(J, delays) == rdrv.run(J, delays)          # framework-free clock
    assert tdrv.job_done_time == rdrv.job_done_time
    assert tdrv.compute_units == pytest.approx(rdrv.compute_units, rel=1e-12)
    assert sorted(tcap) == sorted(rcap) == list(range(1, J + 1))
    for job in tcap:
        _close_trees(tcap[job], _np_tree(jax, rcap[job]), atol=1e-4, rtol=1e-4)
        _close_trees(tcap[job], {k: v.numpy() for k, v in tdrv.full_gradient(job).items()},
                     atol=1e-4, rtol=1e-4)
    for m in range(2):
        np.testing.assert_allclose(tdrv.losses[m], rdrv.losses[m], rtol=1e-3)
    assert tdrv.encodes + tdrv.decodes > 0


@pytest.mark.parametrize("name,kw", [("gc", dict(s=3, prefer_rep=False)),
                                     ("m-sgc", dict(B=1, W=2, lam=2))])
def test_vectorized_trainer_matches_reference(ref, name, kw):
    jax, jnp, r = ref
    J, models = 3, 2
    jcfg, tcfg = _tiny(r["configs"].get_smoke(ARCH)), _tiny(tcfgs.get_smoke(ARCH))
    delays = GilbertElliotSource(n=N, seed=0).sample_delays(J + 4)
    rtr = r["train"].VectorizedCodedTrainer(scheme=r["core"].make_scheme(name, N, J, **kw),
                                            cfg=jcfg, num_models=models, batch_size=BATCH,
                                            seq_len=SEQ, lr=1e-3, seed=0)
    ttr = VectorizedCodedTrainer(scheme=make_scheme(name, N, J, **kw), cfg=tcfg,
                                 num_models=models, batch_size=BATCH, seq_len=SEQ, lr=1e-3,
                                 seed=0, device="cpu")
    ttr.params = [params_from_jax(_np_tree(jax, p), tcfg, device="cpu") for p in rtr.params]
    ttr.opt = [adamw_init(p) for p in ttr.params]
    ttr._job_batch = lambda job: {
        k: torch.tensor(np.asarray(v)) for k, v in rtr._job_batch(job).items()}
    assert ttr.run(J, delays) == rtr.run(J, delays)
    assert ttr.job_done_time == rtr.job_done_time
    for m in range(models):
        assert len(ttr.losses[m]) == len(rtr.losses[m])
        assert np.isfinite(ttr.losses[m]).all()
        np.testing.assert_allclose(ttr.losses[m], rtr.losses[m], rtol=1e-3)


# -- entry points ----------------------------------------------------------------------


def test_train_entry_points_run_on_cpu():
    res = train_demo("gc", jobs=4, n=8, models=2, device="cpu", check_decodes=True)
    assert res.clock > 0 and sorted(res.driver.job_done_time) == [1, 2, 3, 4]
    assert res.max_decode_err < 1e-3 and all(np.isfinite(res.final_losses))
    assert res.driver.decodes == 2 * 4  # each job decoded twice: checked and applied
    losses = train_arch(ARCH, steps=2, coded=True, device="cpu")
    assert len(losses) == 2 and np.isfinite(losses).all()


def test_train_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_demo("gc", jobs=2, n=8, models=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_arch(ARCH, steps=1, coded=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VectorizedCodedTrainer(scheme=make_scheme("gc", N, 2, s=3),
                               cfg=tcfgs.get_smoke(ARCH), num_models=2)


# -- on the card -------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", [("gc", dict(s=3, prefer_rep=False)),
                                     ("m-sgc", dict(B=1, W=2, lam=2))])
def test_coded_gradient_kernels_match_plain_on_card(cuda_device, name, kw):
    """SMOKE in f32 on the card: the coded gradient through the kernels
    (forward and backward) against the plain path, with the launch counts."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, flash_attention_bwd)
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm, rmsnorm_bwd
    from repro_torch.models import init_params

    cfg = tcfgs.get_smoke(ARCH)
    sch = make_scheme(name, N, 2, **kw)
    num_chunks, _ = sch.chunk_grid()
    decodes = []
    for t in range(1, sch.T + 2):  # job 1 decodes by round 1 + T
        sch.step(t, np.zeros(N, dtype=bool))
        decodes += sch.collect_decodes(t)
    jd = next(d for d in decodes if d.job == 1)
    params = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    coded = coded_slot_batch(token_batch(0, 1, BATCH, SEQ, cfg.vocab_size, device=cuda_device),
                             sch.chunk_slots(1), num_chunks)
    w = torch.from_numpy(sch.decode_weights(jd)).to(cuda_device)
    counters = (flash_attention, flash_attention_bwd, rmsnorm, rmsnorm_bwd)
    for c in counters:
        c.launches = 0
    kl, kg = value_and_grad(lambda p: coded_loss(p, cfg, coded, w, num_chunks), params)
    L = cfg.num_layers
    assert [c.launches for c in counters] == [L, L, 2 * L + 1, 2 * L + 1]
    pl, pg = value_and_grad(lambda p: coded_loss(p, cfg, coded, w, num_chunks, plain=True),
                            params)
    assert float(kl) == pytest.approx(float(pl), rel=1e-5)
    for a, b in zip(tree_leaves(kg), tree_leaves(pg)):
        torch.testing.assert_close(a, b, **GRAD_TOL)


@pytest.mark.cuda
def test_train_demo_launches_one_combine_per_encode_and_decode(cuda_device):
    from repro_torch.kernels.gc_coding.gc_coding import coded_combine

    coded_combine.launches = 0
    res = train_demo("m-sgc", jobs=6, n=16, models=4, device=cuda_device, check_decodes=True)
    drv = res.driver
    assert coded_combine.launches == drv.encodes + drv.decodes > 0
    assert res.max_decode_err < 1e-3
