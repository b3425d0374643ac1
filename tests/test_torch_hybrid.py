"""The port's hybrid family (``repro_torch``, zamba2-2.7b) against the JAX package.

zamba2-2.7b is a Mamba2 stack with ONE shared (weight-tied) attention + MLP
block after every ``attn_every`` of its layers.  On the CPU, in float32, the
JAX package's SMOKE parameters go through ``params_from_jax`` and the port
must match the reference (``use_pallas=False``, ROADMAP C-4) at
``tests/test_prefill.py``'s tolerance: forward logits, prefill logits and
every cache leaf, each decode step with its cache, and ``generate`` token for
token.  The same again at the served head dim 80 (SMOKE's is 64), so the plain
attention at 80 is held on the model path too.  Also: a layer count that does
not split into groups raises in both packages; the bridge keeps the shared
block one dict and the SSM's f32 leaves f32; ``serve()`` equals ``generate``.
On the card (``-m cuda``, skipped without one): the kernel path against
``plain=True`` with its launch counts.
The JAX package is imported inside the fixtures that use it, so that the card
test also runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
import repro_torch.models as tm
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import serve
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import generate

ARCH = "zamba2-2.7b"
# tests/test_prefill.py's prefill/decode tolerance
TOL = dict(rtol=2e-3, atol=2e-3)
# batch, sequence, prompt: 4 decode steps, and a prompt that ends inside a
# chunk of SMOKE's Q = 16
B, S, K = 2, 24, 20


@pytest.fixture(scope="module")
def ref():
    """(jax, jax.numpy, repro.configs, repro.models)."""
    import jax
    import jax.numpy as jnp

    import repro.configs
    import repro.models

    return jax, jnp, repro.configs, repro.models


def _randomize(tree, rng):
    """Random values for the leaves the JAX package initialises to constants:
    the SSM's A_log, D, dt_bias and conv bias, and every norm's gamma."""
    ssm = tree["layers"]["ssm"]
    for name in ("A_log", "D", "dt_bias", "conv_b"):
        ssm[name] = (0.5 * rng.standard_normal(ssm[name].shape)).astype(np.float32)
    shared = tree["shared_attn"]
    for norm in (tree["layers"]["norm1"], ssm["norm"], shared["norm1"], shared["norm2"]):
        norm["gamma"] = (1 + 0.2 * rng.standard_normal(norm["gamma"].shape)).astype(np.float32)


@pytest.fixture(scope="module", params=[64, 80], ids=["smoke", "head_dim80"])
def pair(ref, request):
    """(JAX config, JAX params, port config, port params, tokens) at SMOKE with
    head_dim 64 (SMOKE's) or 80 (the full config's)."""
    jax, jnp, jcfgs, jm = ref
    jcfg = jcfgs.get_smoke(ARCH).replace(head_dim=request.param)
    tcfg = tcfgs.get_smoke(ARCH).replace(head_dim=request.param)
    tree = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0)))
    _randomize(tree, np.random.default_rng(4))
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_jax(tree, tcfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, jparams, tcfg, tparams, toks


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_matches_reference(ref, pair):
    _, jnp, _, jm = ref
    jcfg, jparams, tcfg, tparams, toks = pair
    want, _ = jm.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = tm.forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, S, tcfg.vocab_size) and float(aux) == 0.0
    _close(got, want)


def test_prefill_cache_and_decode_steps_match_reference(ref, pair):
    _, jnp, _, jm = ref
    jcfg, jparams, tcfg, tparams, toks = pair
    jl, jc = jm.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks[:, :K])}, max_seq=S)
    tl, tc = tm.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks[:, :K])}, max_seq=S)
    G = tcfg.num_layers // tcfg.attn_every
    assert set(tc) == set(jc) == {"state", "conv", "shared_k", "shared_v"}
    assert tc["shared_k"].shape == (G, B, tcfg.num_kv_heads, S, tcfg.head_dim)
    assert tc["state"].dtype == torch.float32
    _close(tl, jl)
    for t in range(K, S):
        for name in jc:
            _close(tc[name], jc[name])
        jl, jc = jm.decode_step(jparams, jcfg, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        tl, tc = tm.decode_step(tparams, tcfg, tc, torch.from_numpy(toks[:, t:t + 1]), t)
        _close(tl, jl)
    for name in jc:
        _close(tc[name], jc[name])


def test_generate_matches_reference(ref, pair):
    _, jnp, _, jm = ref
    jcfg, jparams, tcfg, tparams, toks = pair
    want = jm.generate(jparams, jcfg, {"tokens": jnp.asarray(toks[:, :K])}, num_tokens=4)
    got = generate(tparams, tcfg, {"tokens": torch.from_numpy(toks[:, :K])}, num_tokens=4)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_layers_that_do_not_split_into_groups_raise(ref):
    """num_layers % attn_every != 0: the JAX package's reshape into groups
    fails, and the port raises before it runs a layer."""
    jax, jnp, jcfgs, jm = ref
    jcfg = jcfgs.get_smoke(ARCH).replace(num_layers=3)
    tcfg = tcfgs.get_smoke(ARCH).replace(num_layers=3)
    toks = np.zeros((1, 4), np.int32)
    with pytest.raises(TypeError):
        jm.forward(jm.init_params(jcfg, jax.random.PRNGKey(0)), jcfg,
                   {"tokens": jnp.asarray(toks)})
    params = tm.init_params(tcfg, torch.Generator().manual_seed(0))
    batch = {"tokens": torch.from_numpy(toks)}
    for call in (lambda: tm.forward(params, tcfg, batch),
                 lambda: tm.prefill(params, tcfg, batch, max_seq=8)):
        with pytest.raises(ValueError, match="not a multiple of attn_every 2"):
            call()


def test_params_from_jax_keeps_the_shared_block_and_f32_leaves(ref):
    """In a bf16 model: ``layers`` split per layer, ``shared_attn`` one
    unstacked dict of bf16 leaves, the SSM's A_log, D and dt_bias left f32."""
    jax, _, jcfgs, jm = ref
    jcfg = jcfgs.get_smoke(ARCH).replace(dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0)))
    _randomize(tree, np.random.default_rng(8))
    tcfg = tcfgs.get_smoke(ARCH).replace(dtype="bfloat16")
    tparams = params_from_jax(tree, tcfg, device="cpu")
    assert len(tparams["layers"]) == tcfg.num_layers
    shared = tparams["shared_attn"]
    assert set(shared) == {"norm1", "attn", "norm2", "mlp"}
    assert shared["attn"]["wq"].shape == (tcfg.d_model, tcfg.num_heads * tcfg.head_dim)
    assert shared["attn"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(shared["mlp"]["w_up"].float().numpy(),
                                  torch.tensor(np.asarray(tree["shared_attn"]["mlp"]["w_up"],
                                                          np.float32)).bfloat16().float().numpy())
    for i, lp in enumerate(tparams["layers"]):
        for name in tssm.F32_PARAMS:
            assert lp["ssm"][name].dtype == torch.float32
            np.testing.assert_array_equal(lp["ssm"][name].numpy(), tree["layers"]["ssm"][name][i])


def test_serve_on_cpu_matches_generate():
    cfg = tcfgs.get_smoke(ARCH)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    res = serve(cfg, params, batch=2, prompt_len=8, tokens=4, max_seq=16, seed=3, device="cpu")
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    want = generate(params, cfg, {"tokens": torch.from_numpy(prompt)}, num_tokens=4, max_seq=16)
    np.testing.assert_array_equal(res.tokens, want.numpy())


# -- on the card -----------------------------------------------------------------


@pytest.mark.cuda
def test_hybrid_on_card_matches_plain_path():
    """SMOKE at head_dim 80 in f32 on the card: the kernel path's logits
    against the plain path's, teacher-forced, and the kernels' launches: one
    attention a call of the shared block, one fused ssd_scan a Mamba2 layer in
    prefill, and 2 * L + 2 * G + 1 RMSNorms a forward (L Mamba2 layers of two
    norms each, G shared calls of two, the final norm)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention as fa
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm as rn
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_chunk_scan as scan

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = tcfgs.get_smoke(ARCH).replace(head_dim=80)
    params = tm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    fa.launches = rn.launches = scan.launches = 0
    kl, kc = tm.prefill(params, cfg, {"tokens": toks[:, :K]}, max_seq=S)
    pl, pc = tm.prefill(params, cfg, {"tokens": toks[:, :K]}, max_seq=S, plain=True)
    torch.testing.assert_close(kl, pl, **TOL)
    for t in range(K, S):
        kl, kc = tm.decode_step(params, cfg, kc, toks[:, t:t + 1], t)
        pl, pc = tm.decode_step(params, cfg, pc, toks[:, t:t + 1], t, plain=True)
        torch.testing.assert_close(kl, pl, **TOL)
    L, G = cfg.num_layers, cfg.num_layers // cfg.attn_every
    assert (fa.launches, scan.launches) == (G, L)
    assert rn.launches == (2 * L + 2 * G + 1) * (1 + S - K)
