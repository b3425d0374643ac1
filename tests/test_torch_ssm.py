"""The port's ssm serving slice (``repro_torch``, mamba2-1.3b) against the JAX package.

On the CPU, in float32 unless a test says otherwise:
  * the plain ``ssd_intra_chunk`` against the JAX package's Pallas kernel
    (interpret mode) and its jnp reference, on ``tests/test_ssd_kernel.py``'s
    shapes and tolerances;
  * ``ssd_chunked``, ``ssm_apply`` (with its decode cache) and
    ``ssm_decode_step`` against the JAX functions;
  * the JAX package's SMOKE parameters through ``params_from_jax``: forward,
    prefill, every decode step and generate;
  * the port alone: prefill + decode == forward, ``serve()`` == generate, a
    bf16 block, the f32 leaves of a bf16 model.
On the card (``-m cuda``, skipped without one): the kernel against its plain
version, and the slice through the kernels against ``plain=True``.
The JAX package is imported inside the tests that use it, so that the card
tests also run where JAX is not installed.
"""

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
import repro_torch.models as tm
from repro_torch.convert import params_from_jax
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_chunk_scan as scan_kernel
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_intra_chunk as ssd_kernel
from repro_torch.launch.serve import serve
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import generate

class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports a device no op implements (an XPU), where
    the ops must refuse it: the meta device, which stood in for one, now takes
    the plain versions (the dry-run's shapes)."""

    @property
    def device(self):
        return torch.device("xpu")


def elsewhere(*shape, requires_grad=False):
    return torch.Tensor._make_subclass(_Elsewhere, torch.empty(*shape), requires_grad)

ARCH = "mamba2-1.3b"
# f32 on the CPU: the two packages differ only in the order of their sums
TOL = dict(rtol=1e-4, atol=1e-4)
# tests/test_ssd_kernel.py's tolerances for the intra-chunk block
SSD_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
# tests/test_prefill.py's prefill/decode tolerance
PREFILL_TOL = dict(rtol=2e-3, atol=2e-3)
B, S, K = 2, 40, 21   # batch, sequence, prompt length: a ragged chunk at SMOKE's Q = 16

# tests/test_ssd_kernel.py's sweep (b, nc, Q, nh, hd, st) and its bf16 case
SWEEP = [(2, 2, 16, 3, 8, 5), (1, 4, 64, 4, 32, 16), (2, 1, 128, 2, 64, 32),
         (1, 2, 64, 8, 8, 128)]
BF16_CASE = (1, 2, 32, 2, 16, 8)


@pytest.fixture(scope="module")
def ref():
    """(jax, jax.numpy, repro.configs, repro.models)."""
    import jax
    import jax.numpy as jnp

    import repro.configs
    import repro.models

    return jax, jnp, repro.configs, repro.models


def _ssd_inputs(rng, b, nc, Q, nh, hd, st, A_scale=1.0):
    """Numpy inputs of the intra-chunk block, as tests/test_ssd_kernel.py draws them."""
    x = rng.standard_normal((b, nc, Q, nh, hd)).astype(np.float32)
    dt = (rng.random((b, nc, Q, nh)) * 0.5 + 0.05).astype(np.float32)
    A = -(rng.random(nh) + 0.1).astype(np.float32) * A_scale
    cum = np.cumsum(dt * A[None, None, None, :], axis=2).astype(np.float32)
    Bm = rng.standard_normal((b, nc, Q, st)).astype(np.float32)
    Cm = rng.standard_normal((b, nc, Q, st)).astype(np.float32)
    return x, dt, cum, Bm, Cm


def _t(a, dtype=torch.float32, device="cpu"):
    return torch.from_numpy(np.array(a, np.float32)).to(device=device, dtype=dtype)


# -- the intra-chunk block: plain version vs the JAX package --------------------


@pytest.mark.parametrize("shape,dtype", [(s, "float32") for s in SWEEP]
                         + [(BF16_CASE, "bfloat16")])
def test_ssd_plain_matches_pallas_and_ref(ref, shape, dtype):
    _, jnp, _, _ = ref
    from repro.kernels.ssd_scan import ops as jops
    from repro.kernels.ssd_scan import ref as jref

    b, nc = shape[:2]
    x, dt, cum, Bm, Cm = _ssd_inputs(np.random.default_rng(7), *shape)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx, jB, jC = (jnp.asarray(a, jdt) for a in (x, Bm, Cm))
    pallas = jops.ssd_intra_chunk(jx, jnp.asarray(dt), jnp.asarray(cum), jB, jC, interpret=True)

    def flat(a):
        return a.reshape((b * nc,) + a.shape[2:])

    jnp_ref = jref.ssd_intra_chunk(flat(jx), flat(jnp.asarray(dt)), flat(jnp.asarray(cum)),
                                   flat(jB), flat(jC)).reshape(pallas.shape)
    got = ssd_ops.ssd_intra_chunk(_t(x, tdt), _t(dt), _t(cum), _t(Bm, tdt), _t(Cm, tdt))
    assert got.dtype == torch.float32 and got.shape == tuple(pallas.shape)
    tol = SSD_TOL[dtype]
    for want in (pallas, jnp_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_ssd_plain_masks_before_it_multiplies():
    """cum decaying steeply: exp(cum_q - cum_u) overflows to inf above the
    diagonal, and the output must still be finite and equal a direct sum."""
    rng = np.random.default_rng(3)
    x, dt, cum, Bm, Cm = _ssd_inputs(rng, 1, 1, 64, 2, 4, 8, A_scale=200.0)
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(cum[0, 0, 0] - cum[0, 0, -1])).all()
    got = ssd_ref.ssd_intra_chunk(_t(x[0]), _t(dt[0]), _t(cum[0]), _t(Bm[0]), _t(Cm[0]))
    assert torch.isfinite(got).all()
    x, dt, cum, Bm, Cm = (a[0, 0].astype(np.float64) for a in (x, dt, cum, Bm, Cm))
    want = np.zeros((64, 2, 4))
    for q in range(64):
        for u in range(q + 1):
            w = (Cm[q] @ Bm[u]) * np.exp(cum[q] - cum[u])          # (nh,)
            want[q] += (w * dt[u])[:, None] * x[u]
    np.testing.assert_allclose(got[0].numpy(), want, rtol=2e-4, atol=2e-4)


# -- the chunked scan and the block: port vs the JAX package --------------------


def _scan_inputs(rng, b, s, nh, hd, st):
    x = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    dt = (rng.random((b, s, nh)) * 0.4 + 0.1).astype(np.float32)
    A = -(rng.random(nh) + 0.2).astype(np.float32)
    Bm = rng.standard_normal((b, s, st)).astype(np.float32)
    Cm = rng.standard_normal((b, s, st)).astype(np.float32)
    D = rng.standard_normal(nh).astype(np.float32)
    return x, dt, A, Bm, Cm, D


@pytest.mark.parametrize("s", [48, 37, 10])   # a multiple of Q = 16, ragged, below Q
@pytest.mark.parametrize("return_state", [False, True])
def test_ssd_chunked_matches_reference(ref, s, return_state):
    _, jnp, _, _ = ref
    from repro.models.ssm import ssd_chunked as jscan

    args = _scan_inputs(np.random.default_rng(s), 2, s, 3, 8, 5)
    want = jscan(*(jnp.asarray(a) for a in args), chunk=16, use_pallas=False,
                 return_state=return_state)
    for plain in (False, True):
        got = tssm.ssd_chunked(*(_t(a) for a in args), chunk=16, plain=plain,
                               return_state=return_state)
        if return_state:
            assert got[1].shape == (2, 3, 8, 5)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)
        else:
            assert got.shape == (2, s, 3, 8) and got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_ssd_chunked_matches_reference_pallas_path(ref):
    """The JAX package's ``use_pallas=True`` path, its kernel in interpret
    mode (patched in as tests/test_ssd_kernel.py does), on a ragged sequence."""
    _, jnp, _, _ = ref
    from repro.kernels.ssd_scan import ops as jops
    from repro.models.ssm import ssd_chunked as jscan

    args = _scan_inputs(np.random.default_rng(11), 2, 37, 3, 8, 5)
    orig = jops.ssd_intra_chunk

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    jops.ssd_intra_chunk = interp
    try:
        want = jscan(*(jnp.asarray(a) for a in args), chunk=16, use_pallas=True,
                     return_state=True)
    finally:
        jops.ssd_intra_chunk = orig
    got = tssm.ssd_chunked(*(_t(a) for a in args), chunk=16, return_state=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def block(ref):
    """(JAX config, JAX block params, port block params) at SMOKE, with
    non-trivial A_log, D, dt_bias and conv bias."""
    jax, jnp, jcfgs, _ = ref
    from repro.models.ssm import ssm_init

    jcfg = jcfgs.get_smoke(ARCH)
    tree = jax.tree.map(np.asarray, ssm_init(jax.random.PRNGKey(0), jcfg, jnp.float32))
    _randomize_ssm_leaves(tree, np.random.default_rng(5))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = {k: ({kk: _t(vv) for kk, vv in v.items()} if isinstance(v, dict) else _t(v))
          for k, v in tree.items()}
    return jcfg, jp, tp


def _randomize_ssm_leaves(p, rng):
    """Give the leaves the JAX package initialises to constants random values."""
    for name in ("A_log", "D", "dt_bias", "conv_b"):
        p[name] = (0.5 * rng.standard_normal(p[name].shape)).astype(np.float32)


@pytest.mark.parametrize("s", [1, 2, 3, 37])
def test_ssm_apply_and_its_cache_match_reference(ref, block, s):
    _, jnp, _, _ = ref
    from repro.models.ssm import ssm_apply as japply

    jcfg, jp, tp = block
    tcfg = tcfgs.get_smoke(ARCH)
    x = np.random.default_rng(s).standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    jy, jstate, jconv = japply(jp, jnp.asarray(x), jcfg, return_cache=True)
    ty, tstate, tconv = tssm.ssm_apply(tp, _t(x), tcfg, return_cache=True)
    conv_dim = tcfg.ssm_d_inner + 2 * tcfg.ssm_state
    assert tconv.shape == (2, 3, conv_dim) and tstate.dtype == torch.float32
    for g, w in ((ty, jy), (tstate, jstate), (tconv, jconv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(tssm.ssm_apply(tp, _t(x), tcfg).numpy(), np.asarray(jy), **TOL)


def test_ssm_decode_step_matches_reference(ref, block):
    _, jnp, _, _ = ref
    from repro.models.ssm import ssm_decode_step as jstep

    jcfg, jp, tp = block
    tcfg = tcfgs.get_smoke(ARCH)
    rng = np.random.default_rng(9)
    nh, hd, st = tcfg.ssm_heads, tcfg.ssm_head_dim, tcfg.ssm_state
    x = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    state = rng.standard_normal((2, nh, hd, st)).astype(np.float32)
    conv = rng.standard_normal((2, 3, tcfg.ssm_d_inner + 2 * st)).astype(np.float32)
    want = jstep(jp, jnp.asarray(x), jnp.asarray(state), jnp.asarray(conv), jcfg)
    got = tssm.ssm_decode_step(tp, _t(x), _t(state), _t(conv), tcfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_bf16_block_matches_reference(ref):
    """A bf16 block, port against reference within bf16's tolerance: a dtype
    slip (dt, the scan or the state taken in bf16) moves it by more."""
    jax, jnp, jcfgs, _ = ref
    from repro.models.ssm import ssm_apply as japply
    from repro.models.ssm import ssm_init

    jcfg = jcfgs.get_smoke(ARCH).replace(dtype="bfloat16")
    tcfg = tcfgs.get_smoke(ARCH).replace(dtype="bfloat16")
    tree = jax.tree.map(np.asarray, ssm_init(jax.random.PRNGKey(1), jcfg, jnp.bfloat16))
    _randomize_ssm_leaves(tree, np.random.default_rng(6))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_jax({"layers": {"ssm": jax.tree.map(lambda a: a[None], tree)}},
                         tcfg.replace(num_layers=1), device="cpu")["layers"][0]["ssm"]
    assert tp["in_proj"].dtype == torch.bfloat16 and tp["A_log"].dtype == torch.float32
    x = np.random.default_rng(2).standard_normal((2, 37, jcfg.d_model)).astype(np.float32)
    jy, jstate, jconv = japply(jp, jnp.asarray(x, jnp.bfloat16), jcfg, return_cache=True)
    ty, tstate, tconv = tssm.ssm_apply(tp, _t(x, torch.bfloat16), tcfg, return_cache=True)
    assert ty.dtype == tconv.dtype == torch.bfloat16 and tstate.dtype == torch.float32
    for g, w in ((ty, jy), (tstate, jstate), (tconv, jconv)):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w.astype(jnp.float32)),
                                   rtol=3e-2, atol=3e-2)


# -- the model: the JAX package's parameters through params_from_jax -----------


@pytest.fixture(scope="module")
def pair(ref):
    """(JAX config, JAX params, port config, port params, tokens)."""
    jax, jnp, jcfgs, jm = ref
    jcfg, tcfg = jcfgs.get_smoke(ARCH), tcfgs.get_smoke(ARCH)
    tree = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0)))
    _randomize_ssm_leaves(tree["layers"]["ssm"], np.random.default_rng(4))
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


def test_prefill_and_every_decode_step_match_reference(ref, pair):
    _, jnp, _, jm = ref
    jcfg, jparams, tcfg, tparams, toks = pair
    jl, jc = jm.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks[:, :K])}, max_seq=S)
    tl, tc = tm.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks[:, :K])}, max_seq=S)
    assert set(tc) == {"state", "conv"} and tc["state"].dtype == torch.float32
    _close(tl, jl)
    for t in range(K, S):
        for name in ("state", "conv"):
            _close(tc[name], jc[name])
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


def test_params_from_jax_keeps_f32_leaves_in_a_bf16_model(ref):
    jax, _, jcfgs, jm = ref
    jcfg = jcfgs.get_smoke(ARCH).replace(dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0)))
    _randomize_ssm_leaves(tree["layers"]["ssm"], np.random.default_rng(8))
    tparams = params_from_jax(tree, tcfgs.get_smoke(ARCH).replace(dtype="bfloat16"),
                              device="cpu")
    for i, lp in enumerate(tparams["layers"]):
        for name, leaf in lp["ssm"].items():
            if name in tssm.F32_PARAMS:
                assert leaf.dtype == torch.float32, name
                np.testing.assert_array_equal(leaf.numpy(), tree["layers"]["ssm"][name][i])
            elif name == "norm":
                assert leaf["gamma"].dtype == torch.bfloat16
            else:
                assert leaf.dtype == torch.bfloat16, name
    assert tparams["embed"].dtype == tparams["layers"][0]["norm1"]["gamma"].dtype == torch.bfloat16


# -- the port alone ------------------------------------------------------------


def test_init_keeps_the_references_layout():
    cfg = tcfgs.get_smoke(ARCH).replace(dtype="bfloat16")
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    lp = params["layers"][0]
    assert set(lp) == {"norm1", "ssm"} and len(params["layers"]) == cfg.num_layers
    assert params["head"].shape == (cfg.d_model, cfg.vocab_size)
    assert {k for k, v in lp["ssm"].items() if k != "norm" and v.dtype == torch.float32} == \
        set(tssm.F32_PARAMS)
    assert tcfgs.get_config(ARCH).param_count() == 1_446_305_792


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
    torch.testing.assert_close(pre, full[:, :K], **PREFILL_TOL)
    for t in range(K, S):
        logits, cache = tm.decode_step(params, cfg, cache, toks[:, t:t + 1], t)
        torch.testing.assert_close(logits, full[:, t], **PREFILL_TOL)


def test_serve_on_cpu_matches_generate():
    cfg = tcfgs.get_smoke(ARCH)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    res = serve(cfg, params, batch=3, prompt_len=20, tokens=5, max_seq=32, seed=4,
                device="cpu")
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 20)).astype(np.int32)
    want = generate(params, cfg, {"tokens": torch.from_numpy(prompt)}, num_tokens=5,
                    max_seq=32)
    assert res.tokens.shape == (3, 5) and res.tokens.dtype == np.int32
    np.testing.assert_array_equal(res.tokens, want.numpy())


def test_ssd_op_refuses_a_gradient_off_the_cpu():
    """The intra-chunk entry is forward only, as the JAX package's Pallas
    kernel is: a call off the CPU that needs a gradient raises and names the
    fused entry as the differentiable one (here on a device with no
    implementation, which the op otherwise refuses too).  The meta device
    takes the plain version."""
    x = elsewhere(1, 2, 16, 2, 8, requires_grad=True)
    dt, Bm = elsewhere(1, 2, 16, 2), elsewhere(1, 2, 16, 4)
    with pytest.raises(NotImplementedError, match="differentiable entry is ssd_chunk_scan"):
        ssd_ops.ssd_intra_chunk(x, dt, dt, Bm, Bm)
    with pytest.raises(ValueError, match="no implementation"):
        ssd_ops.ssd_intra_chunk(x.detach(), dt, dt, Bm, Bm)
    with torch.no_grad():
        with pytest.raises(ValueError, match="no implementation"):
            ssd_ops.ssd_intra_chunk(x, dt, dt, Bm, Bm)
    meta = [torch.empty(t.shape, device="meta") for t in (x, dt, dt, Bm, Bm)]
    assert ssd_ops.ssd_intra_chunk(*meta).shape == x.shape


def test_other_families_name_their_roadmap_item():
    """Every family of the JAX package is ported, so only a family or frontend
    that neither package has raises, in every entry point that builds or reads
    a model."""
    cfg = tcfgs.get_smoke(ARCH).replace(family="rnn")
    with pytest.raises(ValueError, match="family 'rnn' .* in neither package"):
        tm.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="frontend 'text_stub' is in neither package"):
        tm.init_cache(tcfgs.get_smoke(ARCH).replace(frontend="text_stub"), 1, 8)
    params = tm.init_params(tcfgs.get_smoke(ARCH), torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="in neither package"):
        tm.forward(params, cfg, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})


# -- on the card -----------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


# (b, nc, Q, nh, hd, st, dtype, A_scale): the sweep, its bf16 case, a ragged Q
# and head_dim (no multiple of 4), the full mamba2-1.3b width, and steep decay
KERNEL_CASES = [s + ("float32", 1.0) for s in SWEEP] + [
    BF16_CASE + ("bfloat16", 1.0),
    (2, 3, 50, 3, 20, 5, "float32", 1.0),
    (8, 8, 64, 64, 64, 128, "float32", 1.0),
    (8, 8, 64, 64, 64, 128, "bfloat16", 1.0),
    (1, 2, 64, 4, 16, 8, "float32", 200.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", KERNEL_CASES)
def test_ssd_kernel_matches_plain(case):
    dev = _cuda()
    *shape, dtype, A_scale = case
    x, dt, cum, Bm, Cm = _ssd_inputs(np.random.default_rng(0), *shape, A_scale=A_scale)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    args = (_t(x, tdt, dev), _t(dt, device=dev), _t(cum, device=dev), _t(Bm, tdt, dev),
            _t(Cm, tdt, dev))
    before = ssd_kernel.launches
    got = ssd_ops.ssd_intra_chunk(*args)
    torch.cuda.synchronize()
    assert ssd_kernel.launches == before + 1
    assert torch.isfinite(got).all()
    tol = SSD_TOL[dtype]
    want = ssd_ops.ssd_intra_chunk(*(a.cpu() for a in args))
    torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_ssd_kernel_reads_strided_views_and_refuses_what_it_does_not_take():
    dev = _cuda()
    rng = np.random.default_rng(1)
    # the model's layout: x, B and C are slices of one (bc, Q, conv_dim) projection
    nh, hd, st = 4, 16, 8
    xbc = _t(rng.standard_normal((6, 64, nh * hd + 2 * st)), device=dev)
    x = xbc[..., :nh * hd].reshape(6, 64, nh, hd)
    Bm, Cm = xbc[..., nh * hd:nh * hd + st], xbc[..., nh * hd + st:]
    dt = _t(rng.random((6, 64, nh)) * 0.5, device=dev)
    cum = torch.cumsum(-dt, dim=1)
    got = ssd_kernel(x, dt, cum, Bm, Cm)
    want = ssd_ref.ssd_intra_chunk(x.contiguous(), dt, cum, Bm.contiguous(), Cm.contiguous())
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="Q <= 128"):
        z = torch.zeros(1, 129, 1, 8, device=dev)
        ssd_kernel(z, z[..., 0], z[..., 0], z[:, :, 0], z[:, :, 0])
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        ssd_kernel(x, dt, cum, Bm.bfloat16(), Cm)
    with pytest.raises(ValueError, match="float32"):
        ssd_kernel(x, dt.bfloat16(), cum, Bm, Cm)


@pytest.mark.cuda
def test_ssm_slice_on_card_matches_plain_path():
    """SMOKE in f32 on the card: the kernel path's logits against the plain
    path's, teacher-forced, and the kernels' launch counts."""
    dev = _cuda()
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm as rn

    cfg = tcfgs.get_smoke(ARCH)
    params = tm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    ssd_kernel.launches = scan_kernel.launches = rn.launches = 0
    kl, kc = tm.prefill(params, cfg, {"tokens": toks[:, :K]}, max_seq=S)
    pl, pc = tm.prefill(params, cfg, {"tokens": toks[:, :K]}, max_seq=S, plain=True)
    torch.testing.assert_close(kl, pl, **PREFILL_TOL)
    for t in range(K, S):
        kl, kc = tm.decode_step(params, cfg, kc, toks[:, t:t + 1], t)
        pl, pc = tm.decode_step(params, cfg, pc, toks[:, t:t + 1], t, plain=True)
        torch.testing.assert_close(kl, pl, **PREFILL_TOL)
    L = cfg.num_layers
    # one fused chunk scan per block, none of the intra-chunk entry
    assert (scan_kernel.launches, ssd_kernel.launches) == (L, 0)
    assert rn.launches == (2 * L + 1) * (1 + S - K)
