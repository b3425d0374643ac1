"""Training the ssm and hybrid families: the fused SSD chunk scan's backward
(``repro_torch.kernels.ssd_scan``: ``ref.ssd_chunk_scan_bwd``, the
``ssd_chunk_scan_bwd`` kernel and ``ops._SSDChunkScanFn``) against autograd
and the JAX package.

On the CPU, from the same numpy inputs:
  * ``ref.ssd_chunk_scan_bwd`` against autograd of ``ref.ssd_chunk_scan``
    (f32 and bf16 inputs) and against ``jax.vjp`` of the JAX package's chunk
    output (``src/repro/models/ssm.py:95-140``, ``use_pallas=False``), and
    its linear directions against finite differences of the same output with
    the intra-chunk part through the Pallas kernel in interpret mode (the
    Pallas call has no VJP, ROADMAP C-2), over several chunks, a nonzero
    h_prev, s not a multiple of Q, steep decay;
  * ``_SSDChunkScanFn``'s plumbing with the kernel entries swapped for their
    plain versions: argument order, ``needs_input_grad`` and the ``None``s,
    ``ssd_chunked`` through it against ``jax.vjp`` of the JAX ``ssd_chunked``;
  * mamba2-1.3b SMOKE's ``loss_fn`` gradients (chunk 16, 2 x 40 tokens: 3
    chunks and a tail) against ``jax.grad`` under each remat policy, on the
    plain path and through the autograd function;
  * one coded train step of mamba2-1.3b and zamba2-2.7b SMOKE against the JAX
    package's: loss, moments and parameters;
  * the backward's launch plan (head groups, workspace).
On the card (``-m cuda``, skipped without one): the kernel against the plain
backward, bit-identical on a second call, and the SMOKE coded gradient
through the kernels against the plain path.

Tolerances: f32 sums taken in another order agree to ~1e-6 relative; the
backward's outputs are held at 1e-4 (``GRAD_TOL``) against autograd and the
JAX package.  bf16 outputs (dx, dB, dC for bf16 inputs) are f32 sums rounded
once: one bf16 ulp, 2^-8 relative (``BF16_TOL``).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
import repro_torch.models as tm
from repro_torch.convert import params_from_jax
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.kernels.ssd_scan import ssd_scan as ssd_kernels
from repro_torch.models import ssm as tssm
from repro_torch.optim import adamw_init
from repro_torch.train import make_coded_train_step
from repro_torch.train.coded import value_and_grad
from repro_torch.tree import tree_leaves

GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
NAMES = ("dx", "ddt", "dcum", "dB", "dC", "dh_prev", "dD")
# (b, nc, Q, nh, hd, st, padded tail rows, A_scale): 3 and 4 chunks, s not a
# multiple of Q (a tail in the last chunk), Q 12, steep decay whose unmasked
# exp would overflow above the diagonal
CASES = [
    (2, 3, 16, 3, 8, 5, 0, 1.0),
    (2, 4, 16, 2, 8, 6, 7, 1.0),
    (1, 3, 12, 2, 4, 3, 5, 1.0),
    (1, 2, 16, 2, 8, 4, 0, 200.0),
]
STEEP = CASES[3]


@pytest.fixture(scope="module")
def ref():
    """(jax, jax.numpy, repro.configs, repro.models)."""
    import jax
    import jax.numpy as jnp

    import repro.configs
    import repro.models

    return jax, jnp, repro.configs, repro.models


def _inputs(seed, b, nc, Q, nh, hd, st, tail, A_scale):
    """Numpy chunk-layout inputs (xc, dtc, cum, Bc, Cc, h_prev, D), s and dy;
    the last ``tail`` rows are a sequence's zero padding, as ``_chunk_inputs``
    pads (x, dt, B and C zero there)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, nc, Q, nh, hd)).astype(np.float32)
    dt = (rng.random((b, nc, Q, nh)) * 0.5 + 0.05).astype(np.float32)
    A = (-(rng.random(nh) + 0.1) * A_scale).astype(np.float32)
    Bm = rng.standard_normal((b, nc, Q, st)).astype(np.float32)
    Cm = rng.standard_normal((b, nc, Q, st)).astype(np.float32)
    if tail:
        for a in (x, dt, Bm, Cm):
            a[:, -1, Q - tail:] = 0
    cum = np.cumsum(dt * A, axis=2).astype(np.float32)
    h_prev = (0.5 * rng.standard_normal((b, nc, nh, hd, st))).astype(np.float32)
    D = rng.standard_normal(nh).astype(np.float32)
    s = nc * Q - tail
    dy = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    return (x, dt, cum, Bm, Cm, h_prev, D), s, dy


def _torch(args, dtype=torch.float32):
    """x, B and C in ``dtype``; the rest f32."""
    return [torch.from_numpy(a).to(dtype if i in (0, 3, 4) else torch.float32)
            for i, a in enumerate(args)]


def _autograd(args, s, dy, out_dtype):
    leaves = [a.clone().requires_grad_(True) for a in args]
    y = ssd_ref.ssd_chunk_scan(*leaves, s, out_dtype)
    return torch.autograd.grad(y, leaves, dy.to(out_dtype))


def _close(got, want, dtype, what=""):
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, name, g.dtype, w.dtype)
        tol = BF16_TOL if g.dtype == torch.bfloat16 else GRAD_TOL
        torch.testing.assert_close(g.float(), w.float(), **tol, msg=f"{what} {name}")


# -- the plain backward -------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_backward_matches_autograd(case, dtype):
    np_args, s, dy = _inputs(0, *case)
    args = _torch(np_args, dtype)
    dy = torch.from_numpy(dy).to(dtype)
    got = ssd_ref.ssd_chunk_scan_bwd(*args, s, dy)
    want = _autograd(args, s, dy, dtype)
    assert all(torch.isfinite(g.float()).all() for g in got)
    _close(got, want, dtype, f"{case} {dtype}")
    # no dy reaches the padded rows: their gradients are exactly 0, dcum's too
    b, nc, Q, nh, hd = args[0].shape
    for g in got[:3]:
        assert (g.reshape(b, nc * Q, *g.shape[3:])[:, s:] == 0).all()
    for g in got[3:5]:
        assert (g.reshape(b, nc * Q, -1)[:, s:] == 0).all()


def _jax_chunk_output(jax, jnp, s, pallas=False):
    """The JAX package's chunk output after h_prev (src/repro/models/ssm.py:95-140)
    as a function of the chunk-layout inputs; its intra-chunk part through the
    jnp path, or the Pallas kernel in interpret mode."""
    from repro.kernels.ssd_scan import ops as jops

    def out(xc, dtc, cum, Bc, Cc, h_prev, D):
        b, nc, Q, nh, hd = xc.shape
        L = nc * Q
        if pallas:
            y_intra = jops.ssd_intra_chunk(xc, dtc, cum, Bc, Cc, interpret=True)
        else:
            decay = jnp.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
            mask = jnp.tril(jnp.ones((Q, Q), bool))
            decay = jnp.where(mask[None, None, :, :, None], decay, 0.0)
            scores = jnp.einsum("bcqs,bcus->bcqu", Cc.astype(jnp.float32),
                                Bc.astype(jnp.float32))
            w = scores[..., None] * decay
            xdt = xc.astype(jnp.float32) * dtc[..., None]
            y_intra = jnp.einsum("bcqun,bcunh->bcqnh", w, xdt)
        y_inter = jnp.einsum("bcqs,bcqn,bcnhs->bcqnh", Cc.astype(jnp.float32), jnp.exp(cum),
                             h_prev)
        y = (y_intra + y_inter).reshape(b, L, nh, hd)[:, :s]
        return y + xc.reshape(b, L, nh, hd)[:, :s].astype(jnp.float32) * D[None, None, :, None]

    return out


@pytest.mark.parametrize("case,dtype", [(c, "float32") for c in CASES]
                         + [(CASES[1], "bfloat16")])
def test_plain_backward_matches_jax_vjp(ref, case, dtype):
    """Against jax.vjp of the JAX package's jnp chunk output.  With steep
    decay the JAX package's dcum is NaN: exp overflows to inf above the
    diagonal and its select's zero cotangent meets it in exp's VJP (0 * inf),
    a fault of the reference's jnp path (ROADMAP C-8); the port masks the
    exponent instead, and every other gradient agrees."""
    jax, jnp, _, _ = ref
    np_args, s, dy = _inputs(1, *case)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a, jdt if i in (0, 3, 4) else jnp.float32)
             for i, a in enumerate(np_args)]
    y, vjp = jax.vjp(_jax_chunk_output(jax, jnp, s), *jargs)
    want = [torch.from_numpy(np.array(g.astype(jnp.float32))) for g in vjp(jnp.asarray(dy))]
    got = ssd_ref.ssd_chunk_scan_bwd(*_torch(np_args, tdt), s, torch.from_numpy(dy))
    for name, g, w in zip(NAMES, got, want):
        if case == STEEP and name == "dcum":
            assert torch.isnan(w).any() and torch.isfinite(g).all()
            continue
        tol = BF16_TOL if g.dtype == torch.bfloat16 else GRAD_TOL
        torch.testing.assert_close(g.float(), w, **tol, msg=f"{case} {name}")


@pytest.mark.parametrize("case", [CASES[0], CASES[1], STEEP])
def test_plain_backward_matches_pallas_differences(ref, case):
    """The chunk output with its intra part through the JAX package's Pallas
    kernel (interpret mode) is linear in x, dt, B, C, h_prev and D: for a
    random direction v of each, <dy, f(a + v) - f(a)> = <grad_a, v> up to f32
    rounding.  In cum, a central difference with step 1e-2."""
    jax, jnp, _, _ = ref
    np_args, s, dy = _inputs(2, *case)
    got = ssd_ref.ssd_chunk_scan_bwd(*_torch(np_args), s, torch.from_numpy(dy))
    f = _jax_chunk_output(jax, jnp, s, pallas=True)
    rng = np.random.default_rng(3)

    def dot(y):
        return float(np.sum(np.asarray(y, np.float64) * dy))

    base = dot(f(*np_args))
    for i, (name, g) in enumerate(zip(NAMES, got)):
        v = rng.standard_normal(np_args[i].shape).astype(np.float32)
        if name in ("dx", "ddt", "dB", "dC"):
            v[:, -1, case[2] - case[6]:] = 0  # keep the padding zero, as the model's
        moved = [a + v if j == i else a for j, a in enumerate(np_args)]
        want = float(np.sum(g.double().numpy() * v))
        if name == "dcum":
            eps = 1e-2
            lo = [a - eps * v if j == i else a for j, a in enumerate(np_args)]
            hi = [a + eps * v if j == i else a for j, a in enumerate(np_args)]
            fd = (dot(f(*hi)) - dot(f(*lo))) / (2 * eps)
            assert fd == pytest.approx(want, rel=2e-2, abs=1e-2), name
        else:
            assert dot(f(*moved)) - base == pytest.approx(want, rel=1e-3, abs=1e-2), name


# -- the autograd function, its kernels swapped for the plain versions -------------


def _plain_scan(x, dt, cum, B, C, h_prev, D, nc, s, out_dtype):
    """The forward kernel entry's contract on flattened (b*nc, ...) tensors."""
    def chunked(a):
        return a.reshape((a.shape[0] // nc, nc) + a.shape[1:])

    return ssd_ref.ssd_chunk_scan(*(chunked(a) for a in (x, dt, cum, B, C, h_prev)), D, s,
                                  out_dtype)


def _plain_scan_bwd(x, dt, cum, B, C, h_prev, D, dy, nc, s):
    """The backward kernel entry's contract on flattened (b*nc, ...) tensors."""
    def chunked(a):
        return a.reshape((a.shape[0] // nc, nc) + a.shape[1:])

    grads = ssd_ref.ssd_chunk_scan_bwd(*(chunked(a) for a in (x, dt, cum, B, C, h_prev)), D,
                                       s, dy)
    return tuple(g.reshape((-1,) + g.shape[2:]) if g.dim() > 1 else g for g in grads)


@pytest.fixture
def plain_kernels(monkeypatch):
    """The card's path of ``ops.ssd_chunk_scan`` (``_kernel_path``: flatten, the
    grad decision, ``_SSDChunkScanFn``) on CPU tensors, with the kernel entries
    swapped for their plain versions; returns the calls each entry received."""
    calls = {"fwd": [], "bwd": []}

    def fwd(*a):
        calls["fwd"].append(a)
        return _plain_scan(*a)

    def bwd(*a):
        calls["bwd"].append(a)
        return _plain_scan_bwd(*a)

    monkeypatch.setattr(ssd_ops, "_scan_kernel", fwd)
    monkeypatch.setattr(ssd_ops, "_scan_bwd_kernel", bwd)
    monkeypatch.setattr(ssd_ops, "ssd_chunk_scan", ssd_ops._kernel_path)
    return calls


@pytest.mark.parametrize("need", ["all", "x h_prev", "dt cum D"])
def test_chunk_scan_fn_returns_what_autograd_asks(plain_kernels, need):
    np_args, s, dy = _inputs(4, *CASES[1])
    names = ("x", "dt", "cum", "B", "C", "h_prev", "D")
    wanted = names if need == "all" else need.split()
    leaves = [a.requires_grad_(n in wanted) for n, a in zip(names, _torch(np_args))]
    y = ssd_ops.ssd_chunk_scan(*leaves, s)
    assert y.grad_fn is not None and type(y.grad_fn).__name__.startswith("_SSDChunkScanFn")
    (fwd,) = plain_kernels["fwd"]
    nc = leaves[0].shape[1]
    assert fwd[7:] == (nc, s, torch.float32)
    grads = torch.autograd.grad(y, [a for a in leaves if a.requires_grad], torch.from_numpy(dy))
    (bwd,) = plain_kernels["bwd"]
    assert bwd[8:] == (nc, s) and bwd[7].is_contiguous()
    want = _autograd(_torch(np_args), s, torch.from_numpy(dy), torch.float32)
    for g, w in zip(grads, [w for n, w in zip(names, want) if n in wanted]):
        torch.testing.assert_close(g, w, **GRAD_TOL)
    # the backward itself: None where no gradient is asked, and for nc, s, out_dtype
    ctx = SimpleNamespace(saved_tensors=bwd[:7], nc=nc, s=s,
                          needs_input_grad=tuple(n in wanted for n in names) + (False,) * 3)
    out = ssd_ops._SSDChunkScanFn.backward(ctx, torch.from_numpy(dy))
    assert len(out) == 10 and out[7:] == (None, None, None)
    assert [g is not None for g in out[:7]] == [n in wanted for n in names]


def test_chunk_scan_fn_is_skipped_without_a_gradient(plain_kernels):
    np_args, s, _ = _inputs(5, *CASES[0])
    args = _torch(np_args)
    for a in args:
        a.requires_grad_(True)
    with torch.no_grad():
        y = ssd_ops.ssd_chunk_scan(*args, s, torch.bfloat16)
    assert y.grad_fn is None and y.dtype == torch.bfloat16
    assert len(plain_kernels["fwd"]) == 1 and not plain_kernels["bwd"]
    y = ssd_ops.ssd_chunk_scan(*(a.detach() for a in args), s)
    assert y.grad_fn is None and len(plain_kernels["fwd"]) == 2


def _scan_args(seed, b, s, nh, hd, st, A_scale):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, nh, hd)).astype(np.float32),
            (rng.random((b, s, nh)) * 0.4 + 0.1).astype(np.float32),
            (-(rng.random(nh) + 0.2) * A_scale).astype(np.float32),
            rng.standard_normal((b, s, st)).astype(np.float32),
            rng.standard_normal((b, s, st)).astype(np.float32),
            rng.standard_normal(nh).astype(np.float32))


@pytest.mark.parametrize("s", [64, 45])  # 4 whole chunks of 16; 3 and a tail
def test_ssd_chunked_through_the_fn_matches_jax_vjp(ref, plain_kernels, s):
    """``ssd_chunked`` in its order (pad, cumsum, chunk states and the
    recurrence in torch, then the chunk output through ``_SSDChunkScanFn``)
    against jax.vjp of the JAX package's ``ssd_chunked`` (jnp path): y, the
    final state and the gradients of x, dt, A, B, C and D."""
    jax, jnp, _, _ = ref
    from repro.models.ssm import ssd_chunked as jscan

    args = _scan_args(s, 2, s, 3, 8, 5, 1.0)
    (jy, jh), vjp = jax.vjp(lambda *a: jscan(*a, chunk=16, return_state=True),
                            *(jnp.asarray(a) for a in args))
    rng = np.random.default_rng(6)
    dy = rng.standard_normal(jy.shape).astype(np.float32)
    dh = rng.standard_normal(jh.shape).astype(np.float32)
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, h = tssm.ssd_chunked(*leaves, chunk=16, return_state=True)
    assert len(plain_kernels["fwd"]) == 1
    torch.testing.assert_close(y.detach(), torch.from_numpy(np.array(jy)), **GRAD_TOL)
    torch.testing.assert_close(h.detach(), torch.from_numpy(np.array(jh)), **GRAD_TOL)
    got = torch.autograd.grad((y, h), leaves, (torch.from_numpy(dy), torch.from_numpy(dh)))
    assert len(plain_kernels["bwd"]) == 1
    for name, g, w in zip("x dt A B C D".split(), got, want):
        torch.testing.assert_close(g, torch.from_numpy(np.array(w)), **GRAD_TOL, msg=name)


# -- the model: loss_fn under remat, and the coded step ------------------------------


@pytest.fixture(scope="module")
def mamba_grads(ref):
    """mamba2-1.3b SMOKE: (JAX params as numpy, tokens, jax loss, jax.grad in
    the port's layout)."""
    jax, jnp, jcfgs, jm = ref
    jcfg = jcfgs.get_smoke("mamba2-1.3b")
    tree = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(4)))
    rng = np.random.default_rng(8)
    for lp in (tree["layers"]["ssm"],):  # constants at init: give them values
        lp["A_log"] = (0.5 * rng.standard_normal(lp["A_log"].shape)).astype(np.float32)
        lp["D"] = rng.standard_normal(lp["D"].shape).astype(np.float32)
        lp["dt_bias"] = (0.5 * rng.standard_normal(lp["dt_bias"].shape)).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    jloss, jgrad = jax.jit(jax.value_and_grad(lambda p: jm.loss_fn(p, jcfg, jbatch)))(
        jax.tree.map(jnp.asarray, tree))
    tcfg = tcfgs.get_smoke("mamba2-1.3b")
    want = tree_leaves(params_from_jax(jax.tree.map(np.asarray, jgrad), tcfg, device="cpu"))
    return tree, toks, float(jloss), want


@pytest.mark.parametrize("policy", ["full", "dots", "none"])
@pytest.mark.parametrize("path", ["plain", "fn"])
def test_mamba2_loss_grads_match_jax_under_remat(request, mamba_grads, policy, path):
    """SMOKE's chunk of 16 over 40 tokens: 3 chunks, the last padded.  "fn"
    runs the chunk output through ``_SSDChunkScanFn`` (plain kernels), as the
    card does, inside the remat policy's checkpoint."""
    calls = request.getfixturevalue("plain_kernels") if path == "fn" else None
    tree, toks, jloss, want = mamba_grads
    cfg = tcfgs.get_smoke("mamba2-1.3b").replace(remat_policy=policy)
    assert cfg.ssm_chunk == 16 and toks.shape[1] % 16
    params = params_from_jax(tree, cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    loss, grads = value_and_grad(lambda p: tm.loss_fn(p, cfg, batch), params)
    assert float(loss) == pytest.approx(jloss, abs=1e-4)
    for a, b in zip(tree_leaves(grads), want):
        torch.testing.assert_close(a, b, **GRAD_TOL)
    if calls is not None:
        L = cfg.num_layers
        # "full" and "dots" run each layer's forward again in the backward (the
        # kernel is no matrix product that "dots" keeps)
        assert len(calls["fwd"]) == (L if policy == "none" else 2 * L)
        assert len(calls["bwd"]) == L


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_coded_step_matches_jax(ref, arch):
    """One GC (4, 1) coded step of SMOKE from the same parameters, batch and
    round weights: the loss and the first moment (0.1 g) at GRAD_TOL, the
    parameters within 2 lr + 1e-5 (Adam's first step moves each by about lr
    times the sign of its gradient, whatever its size, so an entry whose
    gradient is ~0 may move either way)."""
    jax, jnp, jcfgs, _ = ref
    import repro.core
    import repro.data
    import repro.train.coded as jcoded

    from repro_torch.core import make_gradient_code
    from repro_torch.data import gc_chunked_batch
    from repro_torch.train import gc_round_weights

    lr = 1e-3
    jcfg, cfg = jcfgs.get_smoke(arch), tcfgs.get_smoke(arch)
    jparams, jopt = jcoded.init_train_state(jcfg, jax.random.PRNGKey(5))
    batch = repro.data.token_batch(0, 1, 8, 40, jcfg.vocab_size)
    jcode = repro.core.make_gradient_code(4, 1)
    jw = jcoded.gc_round_weights(jcode, [0, 2, 3])
    jp, jo, jm = jax.jit(jcoded.make_coded_train_step(jcfg, 4, 1, lr=lr))(
        jparams, jopt, repro.data.gc_chunked_batch(batch, 4, 1), jw)

    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    tb = {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}
    w = gc_round_weights(make_gradient_code(4, 1), [0, 2, 3])
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    p, o, m = make_coded_train_step(cfg, 4, 1, lr=lr)(params, adamw_init(params),
                                                      gc_chunked_batch(tb, 4, 1), w)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-4)
    assert o.step == int(jo.step) == 1

    def port(tree):
        return tree_leaves(params_from_jax(jax.tree.map(np.asarray, tree), cfg, device="cpu"))

    for a, b in zip(tree_leaves(o.m), port(jo.m)):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)
    for a, b in zip(tree_leaves(p), port(jp)):
        torch.testing.assert_close(a, b, rtol=0, atol=2 * lr + 1e-5)


# -- the backward's launch plan ------------------------------------------------------


@pytest.mark.parametrize("bc,nh,st", [(512, 64, 128), (192, 64, 128), (16, 80, 64),
                                      (16, 64, 128), (1, 3, 5), (4096, 2, 512)])
def test_backward_plan_covers_every_head_once(bc, nh, st):
    """For the CUDA-core kernels (64-column state tiles) and the tensor-core
    ones (128 columns at Q <= 64 and d_state > 64, else 64), at Q 64 and 128."""
    sms = 132
    aim = ssd_kernels.BWD_BLOCKS_PER_SM * sms
    for Q in (64, 128):
        for tensor_cores in (False, True):
            tiles, g_inter, hpb_inter, g_intra, hpb_intra = ssd_kernels.bwd_plan(
                bc, Q, nh, st, sms, tensor_cores)
            width = 128 if tensor_cores and Q <= 64 and st > 64 else 64
            assert tiles == -(-st // width)
            for g, per, blocks in ((g_inter, hpb_inter, bc * tiles), (g_intra, hpb_intra, bc)):
                # every head once, no empty group
                assert 1 <= g <= nh and (g - 1) * per < nh <= g * per
                # the heads a group takes: as many as the fewest groups that reach
                # the aim would, or one when even a group a head falls short of it
                wanted = min(nh, -(-aim // blocks))
                assert per == -(-nh // wanted)
            assert ssd_kernels.bwd_workspace(bc, Q, nh, st, tiles, g_inter, g_intra) == (
                bc * tiles * Q * nh + g_inter * bc * Q * st + g_intra * bc * Q * Q + bc * nh)


# -- on the card ---------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


# the cases, and the forward sweep's shapes, mamba2-1.3b's (a few batch-chunks)
# and zamba2-2.7b's widths
CUDA_CASES = CASES + [(2, 2, 16, 3, 8, 5, 0, 1.0), (1, 4, 64, 4, 32, 16, 0, 1.0),
                      (2, 1, 128, 2, 64, 32, 0, 1.0), (1, 2, 64, 8, 8, 128, 0, 1.0),
                      (2, 3, 50, 3, 20, 5, 11, 1.0), (2, 4, 64, 64, 64, 128, 0, 1.0),
                      (2, 2, 64, 80, 64, 64, 30, 1.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_matches_plain(cuda_device, case, dtype):
    np_args, s, dy = _inputs(7, *case)
    args = [a.to(cuda_device) for a in _torch(np_args, dtype)]
    dy = torch.from_numpy(dy).to(cuda_device, dtype)
    b, nc = case[:2]
    flat = [a.reshape((b * nc,) + a.shape[2:]) for a in args[:6]]
    before = ssd_kernels.ssd_chunk_scan_bwd.launches
    got = ssd_kernels.ssd_chunk_scan_bwd(*flat, args[6], dy, nc, s)
    again = ssd_kernels.ssd_chunk_scan_bwd(*flat, args[6], dy, nc, s)
    torch.cuda.synchronize()
    assert ssd_kernels.ssd_chunk_scan_bwd.launches == before + 2
    for g, h in zip(got, again):
        assert torch.equal(g, h)  # bit-identical
    want = ssd_ref.ssd_chunk_scan_bwd(*args, s, dy)
    got = [g.reshape(w.shape) for g, w in zip(got, want)]
    assert all(torch.isfinite(g.float()).all() for g in got)
    tol = 2e-3 if dtype == torch.float32 else 3e-2
    for name, g, w in zip(NAMES, got, want):
        scale = max(1.0, float(w.float().abs().max()))
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol * scale, msg=name)


@pytest.mark.cuda
def test_ssm_coded_gradient_kernels_match_plain_on_card(cuda_device):
    """mamba2-1.3b SMOKE in f32 on the card: the coded gradient through the
    kernels (the fused scan forward twice a layer under remat, its backward
    once) against the plain path."""
    from repro_torch.core import make_gradient_code
    from repro_torch.data import gc_chunked_batch, token_batch
    from repro_torch.models import init_params
    from repro_torch.train import gc_round_weights
    from repro_torch.train.coded import coded_loss

    cfg = tcfgs.get_smoke("mamba2-1.3b")
    params = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    coded = gc_chunked_batch(token_batch(0, 1, 8, 40, cfg.vocab_size, device=cuda_device), 4, 1)
    w = gc_round_weights(make_gradient_code(4, 1), [0, 1, 3]).to(cuda_device)
    fwd, bwd = ssd_kernels.ssd_chunk_scan, ssd_kernels.ssd_chunk_scan_bwd
    fwd.launches = bwd.launches = 0
    kl, kg = value_and_grad(lambda p: coded_loss(p, cfg, coded, w, 4), params)
    L = cfg.num_layers
    assert (fwd.launches, bwd.launches) == (2 * L, L)
    pl, pg = value_and_grad(lambda p: coded_loss(p, cfg, coded, w, 4, plain=True), params)
    assert float(kl) == pytest.approx(float(pl), rel=1e-5)
    for a, b in zip(tree_leaves(kg), tree_leaves(pg)):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=1e-4)
