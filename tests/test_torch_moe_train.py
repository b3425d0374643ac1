"""The port's moe training (``repro_torch``: qwen2-moe-a2.7b, mixtral-8x22b)
against the JAX package, on the CPU in float32.

The same numpy inputs go through the JAX package (``use_pallas=False``,
ROADMAP C-4) and the port:

* ``moe_apply`` with ``segment``: its capacity groups within each segment
  equal the JAX package's function run on each segment alone.
* The coded loss and its gradient at the coded shape where the batch's flat
  grouping would drop pairs but each chunk's does not (C-P5): against the
  JAX package's per-chunk coded loss (``chunk_loss_sum`` under ``vmap``).
* The uncoded step over a batch whose one group drops pairs, against
  ``jax.grad`` of ``loss_fn``, for both configs.
* ``VectorizedCodedTrainer`` for gc and m-sgc against the JAX package's
  trainer: equal clocks and done times, losses at rtol 1e-3.
* The route log under ``_remat``: one record a layer a step, and a replayed
  log pinning each layer's experts in the forward and in the backward's
  recompute; the experts' gather, whose backward indexes no row twice; a
  coded step that leaves no tensor in a reference cycle.

The SMOKE widths keep the published expert counts (qwen2-moe-a2.7b 60
experts, top-4; mixtral-8x22b 8, top-2), so that groups past 256 tokens
drop pairs as at full width.  Tolerances: ``moe_apply`` within 1e-5 (f32,
sums in other orders), losses within 1e-4 and gradients at
``tests/test_torch_moe.py``'s 1e-4; losses after AdamW updates at 1e-3
(``tests/test_torch_train.py``'s note).  On the card (``-m cuda``, skipped
without one): two identical coded steps give bit-identical gradients, and
the kernels' gradient equals the plain path's with the routing pinned.  The
JAX package is imported inside the fixtures that use it.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch.configs as tcfgs
import repro_torch.models as tm
from repro_torch.convert import mlp_params_from_jax, params_from_jax
from repro_torch.core import GilbertElliotSource, make_gradient_code, make_scheme
from repro_torch.data import gc_chunked_batch, token_batch
from repro_torch.models import layers as tl
from repro_torch.models.transformer import token_nll
from repro_torch.optim import adamw_init
from repro_torch.train import (VectorizedCodedTrainer, gc_round_weights, make_coded_train_step,
                               make_train_step)
from repro_torch.train.coded import coded_loss, value_and_grad
from repro_torch.tree import tree_leaves

ARCHS = ("qwen2-moe-a2.7b", "mixtral-8x22b")
PUBLISHED_EXPERTS = {"qwen2-moe-a2.7b": (60, 4), "mixtral-8x22b": (8, 2)}
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# C-P5's coded shape: (4, 1)-GC, chunks of 2 sequences of 64 tokens
N, S, CHUNK_BS, SEQ = 4, 1, 2, 64


@pytest.fixture(scope="module")
def ref():
    """(jax, jax.numpy, the JAX package's modules by name)."""
    import jax
    import jax.numpy as jnp

    import repro.configs
    import repro.core
    import repro.data
    import repro.models
    import repro.models.layers
    import repro.train
    import repro.train.coded

    return jax, jnp, {"configs": repro.configs, "core": repro.core, "data": repro.data,
                      "models": repro.models, "layers": repro.models.layers,
                      "train": repro.train, "coded": repro.train.coded}


def _cfgs(ref, arch, **kw):
    """(JAX config, port config): SMOKE with the published expert counts."""
    E, K = PUBLISHED_EXPERTS[arch]
    kw = dict(num_experts=E, num_experts_per_tok=K, **kw)
    return ref[2]["configs"].get_smoke(arch).replace(**kw), tcfgs.get_smoke(arch).replace(**kw)


def _params(ref, jcfg, tcfg, seed=0):
    """(JAX params, the port's copy of them)."""
    jax = ref[0]
    jparams = ref[2]["models"].init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


def _torch(batch):
    return {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}


def _close_grads(ref, got, want, tcfg):
    jax = ref[0]
    want = tree_leaves(params_from_jax(jax.tree.map(np.asarray, want), tcfg, device="cpu"))
    got = tree_leaves(got)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


def _drops(fn):
    """fn() under a route log: (its result, the pairs each moe call dropped)."""
    with tl.route_log() as log:
        out = fn()
    return out, log.drops()


def test_moe_apply_segments_match_reference_per_segment(ref):
    """Four sequences of 256 tokens in segments of two: groups of 512 within
    each segment at capacity factor 0.5 drop pairs, and the result equals the
    JAX package's ``moe_apply`` on each segment alone, where the whole
    batch's groups of 1,024 would keep others."""
    jax, jnp, r = ref
    small = dict(d_model=32, num_experts=6, num_experts_per_tok=2, moe_d_ff=16,
                 num_shared_experts=1)
    jcfg = r["configs"].get_smoke(ARCHS[0]).replace(**small)
    tcfg = tcfgs.get_smoke(ARCHS[0]).replace(**small)
    tree = jax.tree.map(np.asarray, r["layers"].moe_init(jax.random.PRNGKey(3), jcfg,
                                                         np.float32))
    x = np.random.default_rng(3).standard_normal((4, 256, 32)).astype(np.float32)
    kw = dict(capacity_factor=0.5)
    p = mlp_params_from_jax(tree, device="cpu")
    (out, _), drops = _drops(lambda: tl.moe_apply(p, torch.from_numpy(x), tcfg, segment=512,
                                                  **kw))
    want = np.concatenate([np.asarray(r["layers"].moe_apply(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x[i:i + 2]), jcfg, **kw)[0])
        for i in (0, 2)])
    assert drops[0] > 0 and tl.moe_groups(512, tcfg, **kw) == (512, 85)
    np.testing.assert_allclose(out.numpy(), want, **MOE_TOL)
    whole, _ = tl.moe_apply(p, torch.from_numpy(x), tcfg, **kw)
    assert (whole - out).abs().max() > 1e-3
    with pytest.raises(ValueError, match="do not split"):
        tl.moe_apply(p, torch.from_numpy(x), tcfg, segment=300)


def test_coded_loss_groups_within_each_chunk_as_the_reference(ref):
    """C-P5: at (4, 1)-GC with chunks of 2 x 64 tokens, the JAX package's
    coded loss runs each chunk alone (128 tokens: dropless); the 16
    sequences' flat grouping (1,024 tokens, Cg 85) drops pairs.  The port's
    coded loss and gradient equal the reference's, with no pair dropped."""
    jax, jnp, r = ref
    jcfg, tcfg = _cfgs(ref, ARCHS[0])
    jparams, tparams = _params(ref, jcfg, tcfg)
    batch = r["data"].token_batch(0, 1, N * CHUNK_BS, SEQ, jcfg.vocab_size)
    jcoded = r["data"].gc_chunked_batch(batch, N, S)
    jw = r["coded"].gc_round_weights(r["core"].make_gradient_code(N, S), [0, 1, 3])
    tw = gc_round_weights(make_gradient_code(N, S), [0, 1, 3])
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))

    def jloss(p):
        per = jax.vmap(jax.vmap(lambda ch, w: w * r["coded"].chunk_loss_sum(p, jcfg, ch)))(
            jcoded, jw)
        return per.sum() / (N * CHUNK_BS)

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(jparams)
    tcoded = gc_chunked_batch(_torch(batch), N, S)
    (loss, got), drops = _drops(
        lambda: value_and_grad(lambda p: coded_loss(p, tcfg, tcoded, tw, N), tparams))
    assert drops == [0] * tcfg.num_layers
    assert float(loss) == pytest.approx(float(want_loss), abs=1e-4)
    _close_grads(ref, got, want, tcfg)
    # the whole batch as one segment: the grouping the loss must not take
    flat = {k: v.reshape(-1, SEQ) for k, v in tcoded.items()}
    assert tl.moe_groups(flat["tokens"].numel(), tcfg) == (1024, 85)
    _, drops = _drops(lambda: token_nll(tparams, tcfg, flat))
    assert min(drops) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_uncoded_step_with_drops_matches_jax_grad(ref, arch):
    """One group of 8 x 64 = 512 tokens, which drops pairs (qwen2-moe Cg 42,
    mixtral Cg 160): ``make_train_step``'s gradient (aux weight 0.01)
    against ``jax.grad`` of ``loss_fn``, and the step's loss."""
    jax, jnp, r = ref
    jcfg, tcfg = _cfgs(ref, arch)
    jparams, tparams = _params(ref, jcfg, tcfg, seed=1)
    batch = r["data"].token_batch(0, 2, 8, 64, jcfg.vocab_size)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: r["models"].loss_fn(p, jcfg, batch)))(jparams)
    tb = _torch(batch)
    (loss, got), drops = _drops(
        lambda: value_and_grad(lambda p: tm.loss_fn(p, tcfg, tb), tparams))
    assert min(drops) > 0, drops
    assert float(loss) == pytest.approx(float(want_loss), abs=1e-4)
    _close_grads(ref, got, want, tcfg)
    _, _, metrics = make_train_step(tcfg)(tparams, adamw_init(tparams), tb)
    assert float(metrics["loss"]) == pytest.approx(float(want_loss), abs=1e-4)


@pytest.mark.parametrize("name,kw", [("gc", dict(s=3, prefer_rep=False)),
                                     ("m-sgc", dict(B=1, W=2, lam=2))])
def test_vectorized_trainer_matches_reference(ref, name, kw):
    """qwen2-moe SMOKE (1 layer) under both trainers: GC's step is 128
    sequences of 16 tokens, whose flat groups of 1,024 would drop pairs;
    its chunks of 4 sequences do not, in either package."""
    jax, jnp, r = ref
    J, models, n, batch, seq = 3, 2, 8, 32, 16
    jcfg, tcfg = _cfgs(ref, ARCHS[0], num_layers=1)
    delays = GilbertElliotSource(n=n, seed=0).sample_delays(J + 4)
    rtr = r["train"].VectorizedCodedTrainer(scheme=r["core"].make_scheme(name, n, J, **kw),
                                            cfg=jcfg, num_models=models, batch_size=batch,
                                            seq_len=seq, lr=1e-3, seed=0)
    ttr = VectorizedCodedTrainer(scheme=make_scheme(name, n, J, **kw), cfg=tcfg,
                                 num_models=models, batch_size=batch, seq_len=seq, lr=1e-3,
                                 seed=0, device="cpu")
    ttr.params = [params_from_jax(jax.tree.map(np.asarray, p), tcfg, device="cpu")
                  for p in rtr.params]
    ttr.opt = [adamw_init(p) for p in ttr.params]
    ttr._job_batch = lambda job: _torch(rtr._job_batch(job))
    with tl.route_log() as log:
        assert ttr.run(J, delays) == rtr.run(J, delays)
    assert ttr.job_done_time == rtr.job_done_time
    assert len(log.calls) == J and log.drops() == [0] * J   # one layer, one step a job
    for m in range(models):
        assert len(ttr.losses[m]) == len(rtr.losses[m])
        assert np.isfinite(ttr.losses[m]).all()
        np.testing.assert_allclose(ttr.losses[m], rtr.losses[m], rtol=1e-3)


# -- the route log and the gather ---------------------------------------------------


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_route_log_pins_each_layer_under_remat(policy):
    """A gradient under ``_remat`` records each layer once, in order, though
    the backward runs every layer body again; replayed into another model's
    gradient, the log pins each layer's experts in the forward and in the
    recompute, so that gradient equals the same model's without remat under
    the same pins."""
    cfg = tcfgs.get_smoke(ARCHS[0]).replace(num_layers=3, num_experts=8,
                                            remat_policy=policy)
    assert cfg.remat
    batch = token_batch(0, 1, 2, 16, cfg.vocab_size)
    first = tm.init_params(cfg, torch.Generator().manual_seed(0))
    other = tm.init_params(cfg, torch.Generator().manual_seed(1))
    with tl.route_log() as log:
        value_and_grad(lambda p: tm.loss_fn(p, cfg, batch), first)
    L = cfg.num_layers
    assert log.layers == list(range(L)) and len(log.calls) == L
    with tl.route_log() as free:
        value_and_grad(lambda p: tm.loss_fn(p, cfg, batch), other)
    assert any(not torch.equal(a[0], b[0]) for a, b in zip(log.calls, free.calls))
    grads = []
    for c in (cfg, cfg.replace(remat=False)):
        with tl.route_log(tl.RouteLog(replay=log)) as pinned:
            grads.append(value_and_grad(lambda p: tm.loss_fn(p, c, batch), other)[1])
        assert pinned.layers == list(range(L))
        for a, b in zip(pinned.calls, log.calls):
            assert torch.equal(a[0], b[0])
    for a, b in zip(tree_leaves(grads[0]), tree_leaves(grads[1])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_route_log_recompute_takes_its_own_forwards_record(policy):
    """Two forwards under one log before their backward (gradient
    accumulation): each forward's recompute replays the record that forward
    made, not the layer's last, so the gradient under ``_remat`` equals the
    gradient without it."""
    cfg = tcfgs.get_smoke(ARCHS[0]).replace(num_layers=2, num_experts=8,
                                            remat_policy=policy)
    assert cfg.remat
    batches = [token_batch(seed, 1, 2, 16, cfg.vocab_size) for seed in (0, 1)]
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    grads = []
    for c in (cfg, cfg.replace(remat=False)):
        with tl.route_log() as log:
            grads.append(value_and_grad(
                lambda p: sum(tm.loss_fn(p, c, batch) for batch in batches), params)[1])
        assert log.layers == list(range(c.num_layers)) * 2
        assert any(not torch.equal(a[0], b[0]) for a, b in zip(log.calls[:2], log.calls[2:]))
    for a, b in zip(tree_leaves(grads[0]), tree_leaves(grads[1])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_route_log_replays_by_layer_and_pass():
    """Two passes of two layers (a prefill, then a decode step): the replayed
    log's n-th call of a layer pins the n-th call of the same layer, whatever
    the order of the calls between layers."""
    cfg = tcfgs.get_smoke(ARCHS[0])
    p = tl.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    gen = torch.Generator().manual_seed(1)
    xs = [torch.randn(2, 8, cfg.d_model, generator=gen) for _ in range(4)]
    order = [(0, xs[0]), (1, xs[1]), (0, xs[2]), (1, xs[3])]
    with tl.route_log() as log:
        for layer, x in order:
            tl.moe_apply(p, x, cfg, layer=layer)
    with tl.route_log(tl.RouteLog(replay=log)) as pinned:
        for layer, x in (order[1], order[0], order[3], order[2]):
            tl.moe_apply(p, -x, cfg, layer=layer)
    assert pinned.layers == [1, 0, 1, 0]
    for layer in (0, 1):
        for n in (0, 1):
            assert torch.equal(pinned.call(layer, n)[0], log.call(layer, n)[0])
    moved = log.to("cpu")
    assert moved.layers == log.layers and moved.replay is None
    assert all(torch.equal(a[0], b[0]) for a, b in zip(moved.calls, log.calls))


class _IndexPuts(TorchDispatchMode):
    """Records each ``index_put``'s destination rows and row indices."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.index_put.default:
            self.calls.append((args[0].shape[0], args[1][0].clone()))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_gather_backward_indexes_no_row_twice(capacity_factor):
    """The backward of ``moe_apply`` (groups of 512, dropless or dropping)
    writes the gradient of the gathered expert rows into the (T * K, d) copy
    of x with no index repeated, and into the experts' outputs with only the
    zero row of the dropped pairs repeated, whose gradient is thrown away."""
    cfg = tcfgs.get_smoke(ARCHS[0]).replace(num_experts=8, num_experts_per_tok=2)
    p = tl.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn(2, 256, cfg.d_model, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    T, K = 512, cfg.num_experts_per_tok
    with tl.route_log() as log:
        out, _ = tl.moe_apply(p, x, cfg, capacity_factor=capacity_factor, group_size=512)
    dropped = log.drops()[0]
    assert (dropped > 0) == (capacity_factor < 1)
    with _IndexPuts() as puts:
        out.square().sum().backward()
    (gather,) = [idx for rows, idx in puts.calls if rows == T * K]
    assert gather.numel() == T * K - dropped and gather.unique().numel() == gather.numel()
    (combine,) = [(rows, idx) for rows, idx in puts.calls if rows == T * K - dropped + 1]
    rows, idx = combine
    values, counts = idx.unique(return_counts=True)
    assert (values[counts > 1] == rows - 1).all()
    assert int(counts[values == rows - 1].sum()) == dropped
    assert len(puts.calls) == 2


def test_training_step_leaves_no_tensor_in_a_reference_cycle():
    """A coded step (remat, the route log's recompute context, the tree
    helpers) frees its gradients and the parameters' aliases when it returns:
    none waits in a reference cycle for Python's collector, which at full
    width would hold a step's gradients (gigabytes) on the card until it
    runs."""
    import gc

    cfg = tcfgs.get_smoke(ARCHS[0])
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    opt = adamw_init(params)
    step = make_coded_train_step(cfg, N, S)
    coded = gc_chunked_batch(token_batch(0, 1, N * CHUNK_BS, 16, cfg.vocab_size), N, S)
    w = gc_round_weights(make_gradient_code(N, S), [0, 1, 3])
    params, opt, _ = step(params, opt, coded, w)  # the first call's one-time set-up
    gc.collect()
    gc.disable()
    try:
        with tl.route_log():
            params, opt, _ = step(params, opt, coded, w)
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        cycled = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert cycled == []


# -- on the card ---------------------------------------------------------------------


@pytest.mark.cuda
def test_coded_step_on_card_is_bit_identical_and_matches_plain():
    """qwen2-moe SMOKE in f32 on the card at C-P5's coded shape: two identical
    coded gradients (kernels forward and backward, remat) are bit for bit
    the same in every leaf, drop no pair, and equal the plain path's with the
    routing pinned to the kernel path's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    E, K = PUBLISHED_EXPERTS[ARCHS[0]]
    cfg = tcfgs.get_smoke(ARCHS[0]).replace(num_experts=E, num_experts_per_tok=K)
    params = tm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    coded = gc_chunked_batch(token_batch(0, 1, N * CHUNK_BS, SEQ, cfg.vocab_size, device=dev),
                             N, S)
    w = gc_round_weights(make_gradient_code(N, S), [0, 1, 3]).to(dev)
    runs = []
    for _ in range(2):
        with tl.route_log() as log:
            runs.append(value_and_grad(lambda p: coded_loss(p, cfg, coded, w, N), params))
    assert log.drops() == [0] * cfg.num_layers
    for a, b in zip(tree_leaves(runs[0][1]), tree_leaves(runs[1][1])):
        assert torch.equal(a, b)
    with tl.route_log(tl.RouteLog(replay=log)):
        pl, pg = value_and_grad(lambda p: coded_loss(p, cfg, coded, w, N, plain=True), params)
    assert float(runs[0][0]) == pytest.approx(float(pl), abs=1e-5)
    for a, b in zip(tree_leaves(runs[0][1]), tree_leaves(pg)):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=1e-4)
