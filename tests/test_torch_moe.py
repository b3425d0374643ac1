"""The port's moe family (``repro_torch``: qwen2-moe-a2.7b, mixtral-8x22b)
against the JAX package, on the CPU in float32.

The same numpy inputs go through the JAX package (``use_pallas=False``,
ROADMAP C-4) and the port:

* ``moe_apply`` alone: dropless; in groups of more than 256 tokens at a
  capacity low enough that pairs drop (the kept pairs counted against the
  capacity rule); and with router columns built so that every token's
  probabilities tie at the K-th place, where the port must choose the
  experts ``jax.lax.top_k`` chooses (the lower index first).
* Both SMOKE configs: ``forward`` logits and aux, ``loss_fn`` and its
  gradient against ``jax.grad``, ``prefill`` with every cache leaf, 4 decode
  steps, ``generate``; for mixtral with a 20-token prompt, past its sliding
  window of 16 in prefill and in decode (and the window shown to bind).
* ``params_from_jax``'s moe leaves, ``serve()`` on the CPU, the routing log
  the card's checks use to pin the experts, and the no-card error.

Tolerances: ``moe_apply`` alone within 1e-5 (f32, sums in other orders);
the models at ``tests/test_prefill.py``'s 2e-3, and gradients at
``tests/test_torch_configs.py``'s 1e-4.  On the card (``-m cuda``, skipped
without one): both SMOKE forwards against the CPU's.  The JAX package is
imported inside the fixtures that use it.
"""

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
import repro_torch.models as tm
from repro_torch.convert import mlp_params_from_jax, params_from_jax
from repro_torch.launch.serve import serve
from repro_torch.models import layers as tl
from repro_torch.models.transformer import generate
from repro_torch.train.coded import value_and_grad
from repro_torch.tree import tree_leaves

ARCHS = ("qwen2-moe-a2.7b", "mixtral-8x22b")
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=2e-3, atol=2e-3)
GRAD_TOL = 1e-4
# batch, sequence, prompt: 4 decode steps; the prompt passes mixtral SMOKE's
# window of 16
B, S, K = 2, 24, 20


@pytest.fixture(scope="module")
def ref():
    """(jax, jax.numpy, repro.configs, repro.models, repro.models.layers)."""
    import jax
    import jax.numpy as jnp

    import repro.configs
    import repro.models
    from repro.models import layers

    return jax, jnp, repro.configs, repro.models, layers


def _moe_cfgs(ref, **kw):
    """A small moe config of both packages: d 32, 6 experts of 16, top-2, one
    shared expert."""
    small = dict(d_model=32, num_experts=6, num_experts_per_tok=2, moe_d_ff=16,
                 num_shared_experts=1, **kw)
    arch = ARCHS[0]
    return ref[2].get_smoke(arch).replace(**small), tcfgs.get_smoke(arch).replace(**small)


def _moe_tree(ref, jcfg, seed=0):
    """The JAX package's ``moe_init`` parameters as numpy."""
    jax, _, _, _, jl = ref
    return jax.tree.map(np.asarray, jl.moe_init(jax.random.PRNGKey(seed), jcfg, np.float32))


def _run_moe(ref, jcfg, tcfg, tree, x, **kw):
    """(port out, port aux, its route log, JAX out, JAX aux) for x (b, s, d)."""
    jax, jnp, _, _, jl = ref
    with tl.route_log() as log:
        out, aux = tl.moe_apply(mlp_params_from_jax(tree, device="cpu"), torch.from_numpy(x),
                                tcfg, **kw)
    jout, jaux = jl.moe_apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), jcfg, **kw)
    return out, aux, log, np.asarray(jout), float(jaux)


def test_moe_groups_follow_the_reference_rule():
    cfg = tcfgs.get_config("qwen2-moe-a2.7b")
    mix = tcfgs.get_config("mixtral-8x22b")
    assert tl.moe_groups(8 * 500, cfg) == (32, 32)       # the serving prompt: dropless
    assert tl.moe_groups(8, cfg) == (8, 8)               # a decode step
    assert tl.moe_groups(32 * 64, cfg) == (1024, 85)     # the coded-training shape
    assert tl.moe_groups(4608, mix) == (512, 160)        # mixtral's prompt of 4,608
    assert tl.moe_groups(1024, cfg, capacity_factor=100.0) == (1024, 6826)


def test_moe_apply_dropless_matches_reference(ref):
    jcfg, tcfg = _moe_cfgs(ref)
    tree = _moe_tree(ref, jcfg)
    x = np.random.default_rng(0).standard_normal((2, 8, 32)).astype(np.float32)
    out, aux, log, jout, jaux = _run_moe(ref, jcfg, tcfg, tree, x)
    assert log.drops() == [0] and log.calls[0][1] is None
    np.testing.assert_allclose(out.numpy(), jout, **MOE_TOL)
    assert float(aux) == pytest.approx(jaux, abs=1e-6)


def test_moe_apply_with_drops_matches_reference(ref):
    """Two groups of 512 tokens at capacity factor 0.5: Cg = int(0.5 * 512 *
    2 / 6) = 85 against a mean load of 171 an expert, so pairs drop; the kept
    pairs are, per group and expert, min(chosen, Cg)."""
    jcfg, tcfg = _moe_cfgs(ref)
    tree = _moe_tree(ref, jcfg, seed=1)
    x = np.random.default_rng(1).standard_normal((2, 512, 32)).astype(np.float32)
    kw = dict(capacity_factor=0.5, group_size=512)
    out, aux, log, jout, jaux = _run_moe(ref, jcfg, tcfg, tree, x, **kw)
    idx, kept, _ = log.calls[0]
    assert tl.moe_groups(1024, tcfg, **kw) == (512, 85)
    chosen = np.zeros((2, 512, 6), np.int64)
    np.put_along_axis(chosen, idx.numpy().reshape(2, 512, 2), 1, axis=-1)
    assert int(kept.sum()) == int(np.minimum(chosen.sum(1), 85).sum())
    assert log.drops()[0] > 100
    np.testing.assert_allclose(out.numpy(), jout, **MOE_TOL)
    assert float(aux) == pytest.approx(jaux, abs=1e-6)


def test_moe_apply_breaks_ties_as_jax_top_k(ref):
    """Integer inputs and router, so logits are exact in both packages: expert
    0's column is random, experts 1-5 share one column, so every token's
    probabilities tie at the 2nd place (between 1-5, or, where expert 0 is not
    first, at the 1st place too).  ``jax.lax.top_k`` returns the lower index
    first; so must the port."""
    jax, jnp, _, _, _ = ref
    jcfg, tcfg = _moe_cfgs(ref)
    tree = _moe_tree(ref, jcfg, seed=2)
    rng = np.random.default_rng(2)
    router = np.repeat(rng.integers(-1, 2, (32, 1)), 6, axis=1)
    router[:, 0] = rng.integers(-2, 3, 32)
    tree["router"] = (0.25 * router).astype(np.float32)
    x = rng.integers(-2, 3, (4, 16, 32)).astype(np.float32)
    out, aux, log, jout, jaux = _run_moe(ref, jcfg, tcfg, tree, x)
    idx, _, gap = log.calls[0]
    assert (gap == 0).all()
    probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, 32) @ tree["router"]), axis=-1)
    want = np.asarray(jax.lax.top_k(probs, 2)[1])
    np.testing.assert_array_equal(idx.numpy(), want)
    assert set(map(tuple, want.tolist())) == {(0, 1), (1, 2)}
    np.testing.assert_allclose(out.numpy(), jout, **MOE_TOL)
    assert float(aux) == pytest.approx(jaux, abs=1e-6)


def test_route_log_replays_the_recorded_experts():
    """Under ``route_log(RouteLog(replay=log))`` each call takes the
    recorded experts, whatever its own input would choose."""
    cfg = tcfgs.get_smoke(ARCHS[0])
    p = tl.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator().manual_seed(1))
    with tl.route_log() as first:
        tl.moe_apply(p, x, cfg)
    with tl.route_log() as other:
        tl.moe_apply(p, -x, cfg)
    assert not torch.equal(first.calls[0][0], other.calls[0][0])
    with tl.route_log(tl.RouteLog(replay=first)) as pinned:
        out, _ = tl.moe_apply(p, -x, cfg)
    assert torch.equal(pinned.calls[0][0], first.calls[0][0])
    assert not torch.allclose(out, tl.moe_apply(p, -x, cfg)[0])


@pytest.fixture(scope="module", params=ARCHS)
def pair(ref, request):
    """(JAX config, JAX params, port config, port params, tokens) at SMOKE,
    qwen2-moe's zero qkv biases made non-zero."""
    jax, jnp, jcfgs, jm, _ = ref
    jcfg, tcfg = jcfgs.get_smoke(request.param), tcfgs.get_smoke(request.param)
    tree = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0)))
    if tcfg.qkv_bias:
        rng = np.random.default_rng(7)
        for name in ("bq", "bk", "bv"):
            leaf = tree["layers"]["attn"][name]
            tree["layers"]["attn"][name] = (0.1 * rng.standard_normal(leaf.shape)).astype(
                np.float32)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_jax(tree, tcfg, "cpu"), toks


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_and_aux_match_reference(ref, pair):
    _, jnp, _, jm, _ = ref
    jcfg, jparams, tcfg, tparams, toks = pair
    want, jaux = jm.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = tm.forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, S, tcfg.vocab_size) and aux.dtype == torch.float32
    _close(got, want)
    assert float(aux) == pytest.approx(float(jaux), abs=1e-5) and float(aux) > 0


def test_loss_and_gradient_match_jax_grad(ref, pair):
    jax, jnp, _, jm, _ = ref
    jcfg, jparams, tcfg, tparams, toks = pair
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    jloss, jgrad = jax.value_and_grad(jm.loss_fn)(jparams, jcfg, jbatch)
    want = tree_leaves(params_from_jax(jax.tree.map(np.asarray, jgrad), tcfg, device="cpu"))
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    loss, grads = value_and_grad(lambda p: tm.loss_fn(p, tcfg, batch), tparams)
    assert float(loss) == pytest.approx(float(jloss), abs=GRAD_TOL)
    got = tree_leaves(grads)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL)


def test_prefill_cache_and_decode_steps_match_reference(ref, pair):
    _, jnp, _, jm, _ = ref
    jcfg, jparams, tcfg, tparams, toks = pair
    jl, jc = jm.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks[:, :K])}, max_seq=S)
    tl_, tc = tm.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks[:, :K])}, max_seq=S)
    assert set(tc) == set(jc) == {"k", "v"}
    assert tc["k"].shape == (tcfg.num_layers, B, tcfg.num_kv_heads, S, tcfg.head_dim_)
    _close(tl_, jl)
    for t in range(K, S):
        for name in jc:
            _close(tc[name], jc[name])
        jl, jc = jm.decode_step(jparams, jcfg, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        tl_, tc = tm.decode_step(tparams, tcfg, tc, torch.from_numpy(toks[:, t:t + 1]), t)
        _close(tl_, jl)
    for name in jc:
        _close(tc[name], jc[name])


def test_generate_matches_reference(ref, pair):
    _, jnp, _, jm, _ = ref
    jcfg, jparams, tcfg, tparams, toks = pair
    want = jm.generate(jparams, jcfg, {"tokens": jnp.asarray(toks[:, :K])}, num_tokens=4)
    got = generate(tparams, tcfg, {"tokens": torch.from_numpy(toks[:, :K])}, num_tokens=4)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pair", [ARCHS[1]], indirect=True)
def test_mixtral_window_binds_in_prefill_and_decode(pair):
    """mixtral SMOKE's window of 16 under the 20-token prompt and 4 decode
    steps of the tests above, which hold it to the JAX package: its logits
    equal the same model's without a window up to position 15, and differ
    from position 16 on, in prefill and in every decode step, so the window
    is what those tests held."""
    _, _, tcfg, tparams, toks = pair
    assert tcfg.sliding_window == 16 < K
    full_cfg = tcfg.replace(sliding_window=0)
    prompt = {"tokens": torch.from_numpy(toks[:, :K])}
    got, tc = tm.prefill(tparams, tcfg, prompt, max_seq=S)
    full, fc = tm.prefill(tparams, full_cfg, prompt, max_seq=S)
    torch.testing.assert_close(got[:, :16], full[:, :16], rtol=1e-5, atol=1e-5)
    assert (got[:, 16:] - full[:, 16:]).abs().amax() > 1e-2
    for t in range(K, S):
        tok = torch.from_numpy(toks[:, t:t + 1])
        got, tc = tm.decode_step(tparams, tcfg, tc, tok, t)
        full, fc = tm.decode_step(tparams, full_cfg, fc, tok, t)
        assert (got - full).abs().amax() > 1e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_splits_the_moe_leaves(ref, arch):
    """In a bf16 model every layer has ``moe`` with router (d, E), w_gate /
    w_up (E, d, f), w_down (E, f, d) and, for qwen2-moe, ``shared`` of width
    num_shared_experts * f, each the JAX leaf's slice rounded to bf16."""
    jax, _, jcfgs, jm, _ = ref
    jcfg = jcfgs.get_smoke(arch).replace(dtype="bfloat16")
    tcfg = tcfgs.get_smoke(arch).replace(dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = params_from_jax(tree, tcfg, device="cpu")
    d, E, f = tcfg.d_model, tcfg.num_experts, tcfg.expert_d_ff
    want = {"router": (d, E), "w_gate": (E, d, f), "w_up": (E, d, f), "w_down": (E, f, d)}
    if tcfg.num_shared_experts:
        sf = tcfg.num_shared_experts * f
        want["shared"] = {"w_gate": (d, sf), "w_up": (d, sf), "w_down": (sf, d)}
    assert len(tparams["layers"]) == tcfg.num_layers
    for i, lp in enumerate(tparams["layers"]):
        assert set(lp) == {"norm1", "attn", "norm2", "moe"}
        moe, jmoe = lp["moe"], tree["layers"]["moe"]
        assert {k: v.shape if not isinstance(v, dict) else {kk: vv.shape for kk, vv in v.items()}
                for k, v in moe.items()} == want
        for a, b in zip(tree_leaves(moe), tree_leaves(jmoe)):
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                a.float().numpy(), torch.from_numpy(np.asarray(b[i], np.float32)).bfloat16()
                .float().numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_on_cpu_matches_generate(arch):
    cfg = tcfgs.get_smoke(arch)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    res = serve(cfg, params, batch=2, prompt_len=20, tokens=4, max_seq=24, seed=3,
                device="cpu")
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    want = generate(params, cfg, {"tokens": torch.from_numpy(prompt)}, num_tokens=4, max_seq=24)
    np.testing.assert_array_equal(res.tokens, want.numpy())


def test_serve_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfgs.get_smoke(ARCHS[0])
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(cfg, params)


# -- on the card -----------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_on_card_matches_the_cpu(arch):
    """SMOKE in f32: the card's forward logits and aux (kernels, cuBLAS expert
    products) against the CPU's on the same parameters, with its routing
    pinned to the CPU's (a 1e-6 difference may tip a near tie), and one
    attention and two RMSNorm launches a layer, plus the final norm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention as fa
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm as rn

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = tcfgs.get_smoke(arch)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
    with tl.route_log() as log:
        want, want_aux = tm.forward(params, cfg, {"tokens": toks})
    on_card = _to(params, dev)
    fa.launches = rn.launches = 0
    with tl.route_log(tl.RouteLog(replay=_to(log, dev))):
        got, aux = tm.forward(on_card, cfg, {"tokens": toks.to(dev)})
    assert (fa.launches, rn.launches) == (cfg.num_layers, 2 * cfg.num_layers + 1)
    torch.testing.assert_close(got.cpu(), want, **TOL)
    assert float(aux) == pytest.approx(float(want_aux), abs=1e-5)


def _to(tree, dev):
    """A parameter tree, or a route log's experts, on ``dev``."""
    if isinstance(tree, tl.RouteLog):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)
