"""The port's vlm and audio families (``repro_torch``) against the JAX package.

paligemma-3b (vlm) is the dense decoder over [patch embeddings | text]: the
batch's ``prefix_embeds`` (the stubbed SigLIP tower's output) come before the
token embeddings, its positions count the prefix, and its loss covers the text
only.  hubert-xlarge (audio) is a non-causal encoder over precomputed
``frames`` with a per-frame loss and no decode step.  On the CPU, in float32,
the JAX package's SMOKE parameters go through ``params_from_jax`` and the port
must match the reference at ``tests/test_prefill.py``'s tolerance: forward
logits, ``loss_fn`` and its gradients against ``jax.grad``, and for the vlm
prefill with every cache row, 4 decode steps at positions P + t, and
``generate``; the vlm also at the served head dim 256 (SMOKE's is 64).  The
JAX package's own ``generate`` fails on a vlm batch (ROADMAP C-7), so the
port's is held to the reference's ``prefill`` + ``decode_step`` at P + t.
The plain attention at head dim 256 is held to the Pallas kernel in interpret
mode and its jnp reference.  On the card (``-m cuda``, skipped without one):
the head-dim-256 forward kernel against the plain version, and the card's
SMOKE forwards against the CPU's.
The JAX package is imported inside the fixtures that use it, so that the card
tests also run where JAX is not installed.
"""

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
import repro_torch.models as tm
from repro_torch.convert import params_from_jax
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.flash_attention.flash_attention import flash_attention as fa_kernel
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_bwd as fa_bwd
from repro_torch.launch.serve import request, serve
from repro_torch.train.coded import value_and_grad
from repro_torch.tree import tree_leaves, tree_map

VLM, AUDIO = "paligemma-3b", "hubert-xlarge"
# tests/test_prefill.py's prefill/decode tolerance
TOL = dict(rtol=2e-3, atol=2e-3)
# f32 gradients: the packages sum in other orders (tests/test_torch_configs.py)
GRAD_TOL = 1e-4
# tests/test_kernels.py's attention tolerances
ATTN_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
# batch, text length, prompt text (4 decode steps); audio frames
B, TEXT, K = 2, 12, 8
FRAMES = 24


@pytest.fixture(scope="module")
def ref():
    """(jax, jax.numpy, repro.configs, repro.models)."""
    import jax
    import jax.numpy as jnp

    import repro.configs
    import repro.models

    return jax, jnp, repro.configs, repro.models


def _params(ref, arch, **replace):
    """(JAX config, JAX params, port config, port params) at SMOKE, every
    norm's gamma random (the JAX package initialises them to 1)."""
    jax, jnp, jcfgs, jm = ref
    jcfg, tcfg = jcfgs.get_smoke(arch).replace(**replace), tcfgs.get_smoke(arch).replace(**replace)
    tree = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(4)
    for norm in (tree["final_norm"], tree["layers"]["norm1"], tree["layers"]["norm2"]):
        norm["gamma"] = (1 + 0.2 * rng.standard_normal(norm["gamma"].shape)).astype(np.float32)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_jax(tree, tcfg, device="cpu")


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def _both(jnp, batch):
    """The numpy batch as a JAX and a torch batch."""
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.fixture(scope="module", params=[64, 256], ids=["smoke", "head_dim256"])
def vlm(ref, request):
    """(JAX config, JAX params, port config, port params, numpy batch) of
    paligemma SMOKE with head_dim 64 (SMOKE's) or 256 (the full config's)."""
    jcfg, jparams, tcfg, tparams = _params(ref, VLM, head_dim=request.param)
    rng = np.random.default_rng(1)
    P = tcfg.num_prefix_tokens
    batch = {"prefix_embeds": rng.standard_normal((B, P, tcfg.d_model)).astype(np.float32),
             "tokens": rng.integers(0, tcfg.vocab_size, (B, TEXT)).astype(np.int32),
             "labels": rng.integers(0, tcfg.vocab_size, (B, TEXT)).astype(np.int32)}
    return jcfg, jparams, tcfg, tparams, batch


@pytest.fixture(scope="module")
def audio(ref):
    """(JAX config, JAX params, port config, port params, numpy batch) of
    hubert SMOKE."""
    jcfg, jparams, tcfg, tparams = _params(ref, AUDIO)
    rng = np.random.default_rng(2)
    batch = {"frames": rng.standard_normal((B, FRAMES, tcfg.d_model)).astype(np.float32),
             "labels": rng.integers(0, tcfg.vocab_size, (B, FRAMES)).astype(np.int32)}
    return jcfg, jparams, tcfg, tparams, batch


def _prompt(batch, k=K):
    return {"prefix_embeds": batch["prefix_embeds"], "tokens": batch["tokens"][:, :k]}


# -- the registry and the bridge ---------------------------------------------------


def test_configs_and_param_counts_equal_the_reference(ref):
    import dataclasses

    jcfgs = ref[2]
    for arch in (VLM, AUDIO):
        for get in ("get_config", "get_smoke"):
            j, t = getattr(jcfgs, get)(arch), getattr(tcfgs, get)(arch)
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
            assert t.param_count() == j.param_count()
    assert tcfgs.get_config(VLM).param_count() == 2_508_662_784
    assert tcfgs.get_config(AUDIO).param_count() == 1_259_705_600
    # the positions before the text, counted in every sequence length
    assert (tcfgs.get_config(VLM).prefix_len, tcfgs.get_smoke(VLM).prefix_len) == (256, 16)
    assert tcfgs.get_config(AUDIO).prefix_len == tcfgs.get_config("qwen2-0.5b").prefix_len == 0


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_params_from_jax_adds_no_leaf(ref, arch):
    """The vlm's head stays tied (``embed.T``, no ``head``), hubert's is its
    own; every layer has the dense family's leaves, shaped as the JAX package's
    stacked arrays' rows."""
    jax = ref[0]
    jcfg, jparams, tcfg, tparams = _params(ref, arch)
    assert ("head" in tparams) == (arch == AUDIO) == ("head" in jparams)
    assert set(tparams) == set(jparams)
    assert len(tparams["layers"]) == tcfg.num_layers
    jl = jax.tree_util.tree_flatten_with_path(jparams["layers"])[0]
    for lp in tparams["layers"]:
        assert set(lp) == {"norm1", "attn", "norm2", "mlp"}
        got = {".".join(p): tuple(v.shape) for p, v in _items(lp)}
        want = {".".join(k.key for k in path): tuple(v.shape[1:]) for path, v in jl}
        assert got == want


def _items(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# -- vlm: paligemma SMOKE ----------------------------------------------------------


def test_vlm_forward_matches_reference(ref, vlm):
    _, jnp, _, jm = ref
    jcfg, jparams, tcfg, tparams, batch = vlm
    jb, tb = _both(jnp, _prompt(batch, TEXT))
    want, _ = jm.forward(jparams, jcfg, jb)
    got, aux = tm.forward(tparams, tcfg, tb)
    assert got.shape == (B, tcfg.num_prefix_tokens + TEXT, tcfg.vocab_size)
    assert float(aux) == 0.0
    _close(got, want)


def test_vlm_loss_covers_the_text_and_its_grads_match_jax(ref, vlm):
    """The loss over the text suffix only, after the causal shift; its
    gradients (the prefix's too) against ``jax.grad``."""
    jax, jnp, _, jm = ref
    jcfg, jparams, tcfg, tparams, batch = vlm
    jb, tb = _both(jnp, batch)
    jloss, (jgrad, jpre) = jax.value_and_grad(
        lambda p, pre: jm.loss_fn(p, jcfg, {**jb, "prefix_embeds": pre}), argnums=(0, 1))(
        jparams, jb["prefix_embeds"])
    pre = tb["prefix_embeds"].clone().requires_grad_(True)
    loss, grads = value_and_grad(
        lambda p: tm.loss_fn(p, tcfg, {**tb, "prefix_embeds": pre}), tparams)
    nll, _ = tm.token_nll(tparams, tcfg, tb)
    assert nll.shape == (B, TEXT - 1)
    assert float(loss) == pytest.approx(float(jloss), abs=GRAD_TOL)
    want = tree_leaves(params_from_jax(jax.tree.map(np.asarray, jgrad), tcfg, device="cpu"))
    for a, b in zip(tree_leaves(grads), want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL)
    (dpre,) = torch.autograd.grad(tm.loss_fn(tparams, tcfg, {**tb, "prefix_embeds": pre}), pre)
    _close(dpre, jpre, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_vlm_prefill_every_cache_row_and_decode_steps_match_reference(ref, vlm):
    """Prefill of P + K positions into a cache of P + TEXT, then TEXT - K
    decode steps at positions P + t, each with its cache."""
    _, jnp, _, jm = ref
    jcfg, jparams, tcfg, tparams, batch = vlm
    P, toks = tcfg.num_prefix_tokens, batch["tokens"]
    jb, tb = _both(jnp, _prompt(batch))
    jl, jc = jm.prefill(jparams, jcfg, jb, max_seq=P + TEXT)
    tl, tc = tm.prefill(tparams, tcfg, tb, max_seq=P + TEXT)
    assert tc["k"].shape == (tcfg.num_layers, B, tcfg.num_kv_heads, P + TEXT, tcfg.head_dim_)
    _close(tl, jl)
    for t in range(K, TEXT):
        for name in ("k", "v"):
            _close(tc[name], jc[name])
        jl, jc = jm.decode_step(jparams, jcfg, jc, jnp.asarray(toks[:, t:t + 1]),
                                jnp.int32(P + t))
        tl, tc = tm.decode_step(tparams, tcfg, tc, torch.from_numpy(toks[:, t:t + 1]), P + t)
        _close(tl, jl)
    for name in ("k", "v"):
        _close(tc[name], jc[name])


def _reference_greedy(jm, jnp, jcfg, jparams, jb, P, n):
    """Greedy tokens from the JAX package's prefill + decode_step, decoding at
    the embedded length P + s (what its ``generate`` should do: ROADMAP C-7)."""
    s = P + jb["tokens"].shape[1]
    logits, cache = jm.prefill(jparams, jcfg, jb, max_seq=s + n)
    token = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    out = [token]
    for i in range(n - 1):
        logits, cache = jm.decode_step(jparams, jcfg, cache, token, jnp.int32(s + i))
        token = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        out.append(token)
    return np.asarray(jnp.concatenate(out, axis=1))


def test_vlm_generate_matches_reference_prefill_and_decode(ref, vlm):
    _, jnp, _, jm = ref
    jcfg, jparams, tcfg, tparams, batch = vlm
    jb, tb = _both(jnp, _prompt(batch))
    want = _reference_greedy(jm, jnp, jcfg, jparams, jb, tcfg.num_prefix_tokens, 4)
    got = tm.generate(tparams, tcfg, tb, num_tokens=4)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_reference_generate_fails_on_a_vlm_batch(ref):
    """ROADMAP C-7: the JAX package's ``generate`` takes the text length for
    the prompt's, so its default cache is shorter than the embedded prompt and
    its prefill pads by a negative amount."""
    _, jnp, _, jm = ref
    jcfg, jparams, tcfg, _ = _params(ref, VLM)
    rng = np.random.default_rng(3)
    jb = {"prefix_embeds": jnp.asarray(rng.standard_normal((1, tcfg.num_prefix_tokens,
                                                             tcfg.d_model)), jnp.float32),
          "tokens": jnp.zeros((1, K), jnp.int32)}
    with pytest.raises(ValueError, match="negative"):
        jm.generate(jparams, jcfg, jb, num_tokens=2)


def test_vlm_serve_equals_generate_and_refuses_a_prompt_within_the_prefix(ref):
    _, _, tcfg, tparams = _params(ref, VLM)
    P = tcfg.num_prefix_tokens
    res = serve(tcfg, tparams, batch=2, prompt_len=P + 5, tokens=4, max_seq=P + 8, seed=3,
                device="cpu")
    prompt = request(tcfg, batch=2, prompt_len=P + 5, seed=3, device="cpu")
    assert prompt["tokens"].shape == (2, 5) and prompt["prefix_embeds"].shape == (2, P, 256)
    want = tm.generate(tparams, tcfg, prompt, num_tokens=4)
    np.testing.assert_array_equal(res.tokens, want.numpy())
    for prompt_len in (P, P - 3):
        with pytest.raises(ValueError, match="sequence shorter than vision prefix"):
            serve(tcfg, tparams, prompt_len=prompt_len, tokens=2, max_seq=P + 8, device="cpu")


# -- audio: hubert SMOKE -----------------------------------------------------------


def test_audio_forward_matches_reference_and_sees_every_frame(ref, audio):
    _, jnp, _, jm = ref
    jcfg, jparams, tcfg, tparams, batch = audio
    assert not tcfg.causal
    jb, tb = _both(jnp, {"frames": batch["frames"]})
    want, _ = jm.forward(jparams, jcfg, jb)
    got, _ = tm.forward(tparams, tcfg, tb)
    assert got.shape == (B, FRAMES, tcfg.vocab_size)
    _close(got, want)
    # non-causal: the last frame moves the first position's logits
    moved = tb["frames"].clone()
    moved[:, -1] += 1.0
    assert not torch.allclose(tm.forward(tparams, tcfg, {"frames": moved})[0][:, 0], got[:, 0])


def test_audio_per_frame_loss_and_grads_match_jax(ref, audio):
    jax, jnp, _, jm = ref
    jcfg, jparams, tcfg, tparams, batch = audio
    jb, tb = _both(jnp, batch)
    jloss, jgrad = jax.value_and_grad(jm.loss_fn)(jparams, jcfg, jb)
    # frames in, an untied head out: the token embedding is not on the path
    assert not np.asarray(jgrad["embed"]).any()
    loss, grads = value_and_grad(
        lambda p: tm.loss_fn({**p, "embed": tparams["embed"]}, tcfg, tb),
        {k: v for k, v in tparams.items() if k != "embed"})
    assert tm.token_nll(tparams, tcfg, tb)[0].shape == (B, FRAMES)
    assert float(loss) == pytest.approx(float(jloss), abs=GRAD_TOL)
    want = params_from_jax(jax.tree.map(np.asarray, jgrad), tcfg, device="cpu")
    del want["embed"]
    for a, b in zip(tree_leaves(grads), tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL)


def test_audio_has_no_decode_step(ref, audio):
    _, _, tcfg, tparams, batch = audio
    with pytest.raises(ValueError, match="encoder-only"):
        serve(tcfg, tparams, device="cpu")
    cache = tm.init_cache(tcfg, B, FRAMES)
    with pytest.raises(ValueError, match="encoder-only"):
        tm.decode_step(tparams, tcfg, cache, torch.zeros((B, 1), dtype=torch.int32), 0)
    with pytest.raises(ValueError, match="encoder-only"):
        tm.generate(tparams, tcfg, {"frames": torch.from_numpy(batch["frames"])}, num_tokens=2)


# -- attention at head dim 256 -------------------------------------------------------


def _randn(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# b, hq, hkv, sq, sk, causal, window, valid_k: MQA group 8 causal and not, a
# ragged 200-key case, window 32 with valid_k
DH256_CASES = [
    (1, 8, 1, 256, 256, True, 0, None),
    (1, 8, 1, 256, 256, False, 0, None),
    (1, 8, 1, 200, 200, True, 0, None),
    (1, 4, 2, 256, 256, True, 32, 200),
]


@pytest.mark.parametrize("b,hq,hkv,sq,sk,causal,window,valid_k", DH256_CASES)
def test_attention_plain_matches_pallas_at_head_dim_256(ref, b, hq, hkv, sq, sk, causal,
                                                        window, valid_k):
    """The plain version against the Pallas kernel (interpret mode; ragged
    lengths padded by its op, ``valid_k`` passed to the kernel itself) and its
    jnp reference (over the first ``valid_k`` keys), in f32."""
    import importlib

    from repro.kernels import flash_attention as jfa

    jkernel = importlib.import_module("repro.kernels.flash_attention.flash_attention")
    jnp = ref[1]
    q, k, v = _randn(5, (b, hq, sq, 256), (b, hkv, sk, 256), (b, hkv, sk, 256))
    got = fa_ops.attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                           window=window) if valid_k is None else fa_ref.attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal, window=window,
        valid_k=valid_k)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    if valid_k is None:
        pallas = jfa.ops.attention(jq, jk, jv, causal=causal, window=window, interpret=True,
                                   force_kernel=True)
    else:
        pallas = jkernel.flash_attention(jq, jk, jv, causal=causal, window=window,
                                         valid_k=valid_k, interpret=True)
    n = sk if valid_k is None else valid_k
    dense = jfa.ref.attention(jq, jk[:, :, :n], jv[:, :, :n], causal=causal, window=window)
    for want in (pallas, dense):
        _close(got, want, rtol=ATTN_TOL["float32"], atol=ATTN_TOL["float32"])


def test_attention_backward_refuses_head_dim_256_before_any_launch():
    """The backward kernels take head dims up to 128 (256 is ROADMAP B-2b):
    the wrapper and ``_AttentionFn`` with a gradient wanted raise before the
    forward or backward launches, and nothing falls back."""
    before = (fa_kernel.launches, fa_bwd.launches)
    q, lse = torch.ones(1, 8, 16, 256), torch.ones(1, 8, 16)
    kv = torch.ones(1, 1, 16, 256)
    with pytest.raises(ValueError, match=r"head_dim in \(32, 64, 80, 128\), got 256.*B-2b"):
        fa_bwd(q, kv, kv, q, lse, q)
    with pytest.raises(ValueError, match="B-2b"):
        fa_ops._AttentionFn.apply(q, kv, kv, True, 0, True)
    assert (fa_kernel.launches, fa_bwd.launches) == before


# -- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


# b, hq, hkv, sq, sk, causal, window, valid_k at head dim 256: chip_smoke.py's
# bf16 edges (single-row and ragged q tiles, sq != sk with valid_k < sk,
# windows, GQA groups 1 to 8, non-causal, rows left without a key) and
# paligemma-3b's served prefill
DH256_EDGES = [
    (2, 4, 2, 64, 64, True, 0, None),
    *[(2, 8, 1, sq, sq, True, 0, None) for sq in (1, 33, 64, 500)],
    (2, 8, 1, 100, 300, False, 0, 250),
    (2, 7, 1, 300, 180, True, 0, 150),
    (2, 8, 2, 200, 77, False, 0, None),
    *[(1, 4, 2, 256, 256, True, w, None) for w in (32, 96, 200)],
    *[(2, 2 * group, 2, 130, 130, True, 0, None) for group in (1, 2, 7, 8)],
    *[(1, 4, 2, 300, 300, causal, 32, 100) for causal in (False, True)],
    (8, 8, 1, 500, 500, True, 0, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,causal,window,valid_k", DH256_EDGES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernel_matches_plain_at_head_dim_256(cuda_device, b, hq, hkv, sq, sk,
                                                        causal, window, valid_k, dtype):
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    q, k, v = _randn(6, (b, sq, hq, 256), (b, sk, hkv, 256), (b, sk, hkv, 256))
    q, k, v = (torch.from_numpy(a).to(cuda_device, td).transpose(1, 2) for a in (q, k, v))
    kw = dict(causal=causal, window=window, valid_k=valid_k)
    before = fa_kernel.launches
    got = fa_kernel(q, k, v, **kw)
    assert fa_kernel.launches == before + 1
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), fa_ref.attention(q, k, v, **kw).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,head_dim", [(VLM, 256), (AUDIO, 64)])
def test_card_smoke_forward_matches_the_cpu(cuda_device, arch, head_dim):
    """f32 SMOKE forwards on the card (the kernels) against the CPU's (the
    plain versions), from the same parameters and batch; at head dim 256 a
    call that wants a gradient raises before any launch (B-2b)."""
    cfg = tcfgs.get_smoke(arch).replace(head_dim=head_dim)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(8)
    if arch == VLM:
        batch = {"prefix_embeds": rng.standard_normal((B, cfg.num_prefix_tokens, cfg.d_model)),
                 "tokens": rng.integers(0, cfg.vocab_size, (B, TEXT))}
    else:
        batch = {"frames": rng.standard_normal((B, FRAMES, cfg.d_model))}
    batch = {k: torch.from_numpy(v.astype(np.int32 if v.dtype.kind == "i" else np.float32))
             for k, v in batch.items()}
    card_params, card_batch = (tree_map(lambda t: t.to(cuda_device), t) for t in (params, batch))
    before = fa_kernel.launches
    with torch.inference_mode():
        got, _ = tm.forward(card_params, cfg, card_batch)
        want, _ = tm.forward(params, cfg, batch)
    assert fa_kernel.launches == before + cfg.num_layers
    torch.testing.assert_close(got.cpu(), want, **TOL)
    if head_dim == 256:
        before = (fa_kernel.launches, fa_bwd.launches)
        with pytest.raises(ValueError, match="B-2b"):
            value_and_grad(lambda p: tm.loss_fn(p, cfg, {**card_batch,
                                                         "labels": card_batch["tokens"]}),
                           card_params)
        assert (fa_kernel.launches, fa_bwd.launches) == before


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_train_arch_refuses_a_stub_frontend(arch):
    """``launch/train.py`` draws token batches; the vlm's patch embeddings and
    hubert's frames are not drawn there, so it raises (ROADMAP A-6b)."""
    from repro_torch.launch.train import train_arch

    with pytest.raises(NotImplementedError, match="stub inputs .*A-6b"):
        train_arch(arch, device="cpu")
