"""The port's serving slice (``repro_torch``) against the JAX package.

The JAX package's parameters at ``qwen2-0.5b`` SMOKE go through
``params_from_jax``; forward, prefill, every decode step and generate must
then match the reference in float32 on the CPU.  Also: the port's own
prefill + decode == forward, ``serve()``, and the package's hygiene (no JAX,
no ``repro`` import; no quiet CPU fallback).  JAX and the JAX package are
imported inside the tests that use them, so that the card test also runs
where JAX is not installed.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
import repro_torch.models as tm
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import serve
from repro_torch.models.transformer import generate

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2-0.5b"
# f32 on the CPU: the two packages differ only in the order of their sums
TOL = dict(rtol=1e-4, atol=1e-4)
B, S, K = 2, 12, 7   # batch, sequence, prompt length (as tests/test_prefill.py)


@pytest.fixture(scope="module")
def ref():
    """(jax, jax.numpy, repro.configs, repro.models)."""
    import jax
    import jax.numpy as jnp

    import repro.configs
    import repro.models

    return jax, jnp, repro.configs, repro.models


@pytest.fixture(scope="module")
def pair(ref):
    """(JAX config, JAX params, port config, port params, tokens)."""
    jax, jnp, jcfgs, jm = ref
    jcfg, tcfg = jcfgs.get_smoke(ARCH), tcfgs.get_smoke(ARCH)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    # non-zero qkv biases, so that the bridge and the bias path are exercised
    rng = np.random.default_rng(7)
    for name in ("bq", "bk", "bv"):
        tree["layers"]["attn"][name] = (
            0.1 * rng.standard_normal(tree["layers"]["attn"][name].shape)
        ).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_jax(tree, tcfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, jparams, tcfg, tparams, toks


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_configs_equal_the_reference(ref):
    jcfgs = ref[2]
    assert tcfgs.ARCHS == jcfgs.ARCHS
    for arch in tcfgs.ARCHS:
        for get in ("get_config", "get_smoke"):
            j, t = getattr(jcfgs, get)(arch), getattr(tcfgs, get)(arch)
            assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_unported_arch_names_its_roadmap_item(ref):
    """The port registers every architecture of the JAX package, so none is
    refused as unported any more; an unknown name raises in both packages."""
    jcfgs = ref[2]
    assert set(tcfgs.ARCHS) == set(jcfgs.ARCHS) >= {"paligemma-3b", "hubert-xlarge"}
    for arch in jcfgs.ARCHS:
        assert tcfgs.get_config(arch).name == arch
    for get in (tcfgs.get_config, jcfgs.get_config):
        with pytest.raises(KeyError, match="unknown arch"):
            get("gemma-7b")


def test_forward_matches_reference(ref, pair):
    _, jnp, _, jm = ref
    jcfg, jparams, tcfg, tparams, toks = pair
    want, _ = jm.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    got, _ = tm.forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, S, tcfg.vocab_size)
    _close(got, want)


def test_prefill_and_every_decode_step_match_reference(ref, pair):
    _, jnp, _, jm = ref
    jcfg, jparams, tcfg, tparams, toks = pair
    jl, jc = jm.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks[:, :K])}, max_seq=S)
    tl, tc = tm.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks[:, :K])}, max_seq=S)
    _close(tl, jl)
    for name in ("k", "v"):
        _close(tc[name], jc[name])
    for t in range(K, S):
        jl, jc = jm.decode_step(jparams, jcfg, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        tl, tc = tm.decode_step(tparams, tcfg, tc, torch.from_numpy(toks[:, t:t + 1]), t)
        _close(tl, jl)


def test_generate_matches_reference(ref, pair):
    _, jnp, _, jm = ref
    jcfg, jparams, tcfg, tparams, toks = pair
    want = jm.generate(jparams, jcfg, {"tokens": jnp.asarray(toks[:, :K])}, num_tokens=6)
    got = generate(tparams, tcfg, {"tokens": torch.from_numpy(toks[:, :K])}, num_tokens=6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bf16_decode_attention_keeps_f32_scores(ref):
    """bf16 decode attention, port against reference, with scores of ~16 (a
    bf16 ulp there is 0.125): both contract the bf16 cache with f32
    accumulation and keep the scores in f32 up to the softmax.  Rounding the
    scores to bf16 first, as the port once did, moves the outputs by about
    2.3e-2.  The tolerance, 2e-3, is below one bf16 ulp of the outputs
    (|out| < 4, ulp 1.6e-2), so the two must round alike."""
    import repro.models.layers as jl

    import repro_torch.models.layers as tl

    _, jnp, jcfgs, _ = ref
    jcfg = jcfgs.get_smoke(ARCH).replace(dtype="bfloat16")
    tcfg = tcfgs.get_smoke(ARCH).replace(dtype="bfloat16")
    d, hq, hkv, dh = tcfg.d_model, tcfg.num_heads, tcfg.num_kv_heads, tcfg.head_dim
    rng = np.random.default_rng(0)
    big = 4.0  # scales q and k, so the scores' spread is ~big**2
    p = {"wq": rng.standard_normal((d, hq * dh)) * big / np.sqrt(d),
         "wk": rng.standard_normal((d, hkv * dh)) * big / np.sqrt(d),
         "wv": rng.standard_normal((d, hkv * dh)) / np.sqrt(d),
         "wo": rng.standard_normal((hq * dh, d)) / np.sqrt(hq * dh),
         "bq": np.zeros(hq * dh), "bk": np.zeros(hkv * dh), "bv": np.zeros(hkv * dh)}
    b, max_seq, pos = 2, 40, 30
    x = rng.standard_normal((b, 1, d))
    ck = rng.standard_normal((b, hkv, max_seq, dh)) * big
    cv = rng.standard_normal((b, hkv, max_seq, dh))

    def j(a):
        return jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()

    want, _, _ = jl.attention_decode({k: j(v) for k, v in p.items()}, j(x), j(ck), j(cv),
                                     jnp.int32(pos), jcfg)
    got = tl.attention_decode({k: t(v) for k, v in p.items()}, t(x), t(ck), t(cv), pos, tcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2e-3, atol=2e-3)

def test_prefill_then_decode_matches_forward():
    """The port alone, with its own initialisation: prefill the first K
    tokens, decode the rest one by one, and match the full forward."""
    cfg = tcfgs.get_smoke(ARCH)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    )
    full, _ = tm.forward(params, cfg, {"tokens": toks})
    pre, cache = tm.prefill(params, cfg, {"tokens": toks[:, :K]}, max_seq=S)
    torch.testing.assert_close(pre, full[:, :K], **TOL)
    for t in range(K, S):
        logits, cache = tm.decode_step(params, cfg, cache, toks[:, t:t + 1], t)
        torch.testing.assert_close(logits, full[:, t], **TOL)


def test_serve_on_cpu_matches_generate():
    cfg = tcfgs.get_smoke(ARCH)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    res = serve(cfg, params, batch=3, prompt_len=8, tokens=5, max_seq=16, seed=4,
                device="cpu")
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 8)).astype(np.int32)
    want = generate(params, cfg, {"tokens": torch.from_numpy(prompt)}, num_tokens=5,
                    max_seq=16)
    assert res.tokens.shape == (3, 5) and res.tokens.dtype == np.int32
    np.testing.assert_array_equal(res.tokens, want.numpy())
    assert res.total_s >= res.prefill_s > 0


def test_serve_without_a_card_raises_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tcfgs.get_smoke(ARCH)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(cfg, params)


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_port_sources_import_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


# -- on the card -----------------------------------------------------------------


@pytest.mark.cuda
def test_serve_slice_on_card_matches_plain_path():
    """SMOKE in f32 on the card: the kernel path's logits against the plain
    path's, teacher-forced, and the kernels' launch counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention as fa
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm as rn

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = tcfgs.get_smoke(ARCH)
    params = tm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    fa.launches = rn.launches = 0
    kl, kc = tm.prefill(params, cfg, {"tokens": toks[:, :K]}, max_seq=S)
    pl, pc = tm.prefill(params, cfg, {"tokens": toks[:, :K]}, max_seq=S, plain=True)
    torch.testing.assert_close(kl, pl, rtol=2e-3, atol=2e-3)
    for t in range(K, S):
        kl, kc = tm.decode_step(params, cfg, kc, toks[:, t:t + 1], t)
        pl, pc = tm.decode_step(params, cfg, pc, toks[:, t:t + 1], t, plain=True)
        torch.testing.assert_close(kl, pl, rtol=2e-3, atol=2e-3)
    L = cfg.num_layers
    assert fa.launches == L
    assert rn.launches == (2 * L + 1) * (1 + S - K)
