"""The port's vlm and audio coded training (``repro_torch``) against the JAX
package, on the CPU in float32, and the attention backward at head dim 256.

paligemma-3b's batch is [patch embeddings | text] (``prefix_embeds``,
``tokens``, ``labels`` over the text), hubert-xlarge's ``frames`` and
per-frame ``labels``: neither is a token batch, and the coded loss counts
its examples and its label length on ``labels`` (an audio batch has no
``tokens``; ROADMAP C-P6).  From the same numpy inputs and converted SMOKE
parameters:

* ``coded_loss`` and ``chunk_loss_sum`` and their gradients on both
  families' batches, through ``gc_chunked_batch`` ((4, 1)-GC with a
  straggler, the cyclic code) and ``coded_slot_batch`` (M-SGC's grid and
  decode weights), against the JAX package's per-chunk coded loss
  (``chunk_loss_sum`` under ``vmap``, the loss its
  ``make_coded_train_step`` differentiates);
* one ``make_coded_train_step`` step of paligemma SMOKE at head dims 64 and
  256 against the reference's step: its loss and the updated parameters;
* the coded gradient against the full-batch gradient (the decode identity).

Tolerances: ``CODED_GRAD_TOL`` (rtol 2e-3, atol 1e-4, as chip_smoke.py's
coded gradient checks) for gradients and updated parameters, losses within
1e-4: f32 sums over a batch taken in other orders.  Adam's first step moves
a parameter by about lr (1e-4) whatever its gradient's size, so an updated
parameter is held at the same atol.

On the card (``-m cuda``, skipped without one): the head-dim-256 backward
kernels against autograd of the plain version over the edges of
``tests/test_torch_vlm_audio.py``'s ``DH256_EDGES``, in f32 and bf16; two
calls bit for bit the same; and the SMOKE coded gradient at head dim 256
through the kernels against the CPU's.  The JAX package is imported inside
the fixture that uses it.
"""

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
from repro_torch.convert import params_from_jax
from repro_torch.core import make_gradient_code, make_scheme
from repro_torch.data import coded_slot_batch, gc_chunked_batch
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.flash_attention.flash_attention import flash_attention as fa_kernel
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_bwd as fa_bwd
from repro_torch.models import loss_fn
from repro_torch.optim import adamw_init
from repro_torch.train import gc_round_weights, make_coded_train_step
from repro_torch.train.coded import chunk_loss_sum, coded_loss, value_and_grad
from repro_torch.tree import tree_leaves, tree_map

VLM, AUDIO = "paligemma-3b", "hubert-xlarge"
CODED_GRAD_TOL = dict(rtol=2e-3, atol=1e-4)
LOSS_TOL = 1e-4
# (4, 1)-GC over chunks of 2 examples, worker 2 straggling; M-SGC (B 1, W 2,
# lambda 2) at n 4 splits a job into 16 chunks of one example
N, S, CHUNK_BS, SURVIVORS = 4, 1, 2, [0, 1, 3]
MSGC = dict(B=1, W=2, lam=2)
TEXT, FRAMES = 12, 24
ATTN_TOL = {"float32": 2e-4, "bfloat16": 3e-2}   # tests/test_kernels.py


@pytest.fixture(scope="module")
def ref():
    """(jax, jax.numpy, the JAX package's modules by name)."""
    import jax
    import jax.numpy as jnp

    import repro.configs
    import repro.core
    import repro.data
    import repro.models
    import repro.train.coded

    return jax, jnp, {"configs": repro.configs, "core": repro.core, "data": repro.data,
                      "models": repro.models, "coded": repro.train.coded}


def _batch(cfg, b, seed):
    """A numpy batch of ``cfg``'s family: patch embeddings, text and text
    labels (vlm), or frames and per-frame labels (audio)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_stub":
        return {"frames": rng.standard_normal((b, FRAMES, cfg.d_model)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (b, FRAMES)).astype(np.int32)}
    P = cfg.num_prefix_tokens
    return {"prefix_embeds": rng.standard_normal((b, P, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (b, TEXT)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, TEXT)).astype(np.int32)}


def _setup(ref, arch, head_dim=None, seed=0):
    """(JAX config, JAX params, port config, port params): SMOKE, at
    ``head_dim`` where given."""
    jax, jnp, r = ref
    kw = {} if head_dim is None else dict(head_dim=head_dim)
    jcfg = r["configs"].get_smoke(arch).replace(**kw)
    tcfg = tcfgs.get_smoke(arch).replace(**kw)
    tree = jax.tree.map(np.asarray, r["models"].init_params(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_jax(tree, tcfg, device="cpu")


def _port(tree_np, cfg):
    return params_from_jax(tree_np, cfg, device="cpu", dtype=torch.float32)


def _close_trees(got, want, **tol):
    g, w = tree_leaves(got), tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.detach().float().cpu().numpy(), b.detach().numpy(), **tol)


def _views(view):
    """(slot grid, weights, num_chunks) of a job: GC's cyclic placement with
    ``SURVIVORS``, or M-SGC's grid and decode weights for job 1 with no
    straggler."""
    if view == "gc":
        idx = (np.arange(N)[:, None] + np.arange(S + 1)[None, :]) % N
        return idx, gc_round_weights(make_gradient_code(N, S, prefer_rep=False), SURVIVORS), N
    sch = make_scheme("m-sgc", N, 1, **MSGC)
    num_chunks, _ = sch.chunk_grid()
    decodes = []
    for t in range(1, 2 + sch.T):
        sch.step(t, np.zeros(N, dtype=bool))
        decodes += sch.collect_decodes(t)
    (jd,) = decodes
    return sch.chunk_slots(1), torch.from_numpy(sch.decode_weights(jd)), num_chunks


@pytest.mark.parametrize("view", ["gc", "m-sgc"])
@pytest.mark.parametrize("arch", [AUDIO, VLM])
def test_coded_loss_matches_the_reference_per_chunk(ref, arch, view):
    """C-P6: the coded loss and its gradient on a frames batch (hubert) and a
    patches + text batch (paligemma), through both coded views, against the
    JAX package's per-chunk coded loss; the parent's port raised
    ``KeyError: 'tokens'`` on the frames batch."""
    jax, jnp, r = ref
    jcfg, jparams, tcfg, tparams = _setup(ref, arch)
    b = N * CHUNK_BS if view == "gc" else 16
    batch = _batch(tcfg, b, seed=1)
    slots, w, num_chunks = _views(view)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jcoded = (r["data"].gc_chunked_batch(jbatch, N, S) if view == "gc"
              else r["data"].coded_slot_batch(jbatch, slots, num_chunks))
    jw = jnp.asarray(w.numpy())
    cb = b // num_chunks

    def jloss(p):
        per = jax.vmap(jax.vmap(lambda ch, wt: wt * r["coded"].chunk_loss_sum(p, jcfg, ch)))(
            jcoded, jw)
        return per.sum() / (num_chunks * cb)

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(jparams)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tcoded = (gc_chunked_batch(tbatch, N, S) if view == "gc"
              else coded_slot_batch(tbatch, slots, num_chunks))
    loss, got = value_and_grad(lambda p: coded_loss(p, tcfg, tcoded, w, num_chunks), tparams)
    assert float(loss) == pytest.approx(float(want_loss), abs=LOSS_TOL)
    _close_trees(got, _port(jax.tree.map(np.asarray, want), tcfg), **CODED_GRAD_TOL)


@pytest.mark.parametrize("arch", [AUDIO, VLM])
def test_chunk_loss_sum_matches_the_reference(ref, arch):
    """One chunk's summed loss and its gradient, counted on ``labels``."""
    jax, jnp, r = ref
    jcfg, jparams, tcfg, tparams = _setup(ref, arch, seed=2)
    batch = _batch(tcfg, CHUNK_BS, seed=3)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: r["coded"].chunk_loss_sum(p, jcfg, {k: jnp.asarray(v)
                                                      for k, v in batch.items()})))(jparams)
    loss, got = value_and_grad(
        lambda p: chunk_loss_sum(p, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()}),
        tparams)
    assert float(loss) == pytest.approx(float(want_loss), abs=LOSS_TOL)
    _close_trees(got, _port(jax.tree.map(np.asarray, want), tcfg), **CODED_GRAD_TOL)


@pytest.mark.parametrize("head_dim", [64, 256])
def test_coded_step_matches_the_reference_step(ref, head_dim):
    """One ``make_coded_train_step`` step of paligemma SMOKE ((4, 1)-GC,
    worker 2 straggling) against the JAX package's: the loss, and every
    parameter after the AdamW update."""
    jax, jnp, r = ref
    jcfg, jparams, tcfg, tparams = _setup(ref, VLM, head_dim=head_dim, seed=3)
    batch = _batch(tcfg, N * CHUNK_BS, seed=4)
    jcode = r["core"].make_gradient_code(N, S, prefer_rep=False)
    jw = r["coded"].gc_round_weights(jcode, SURVIVORS)
    jcoded = r["data"].gc_chunked_batch({k: jnp.asarray(v) for k, v in batch.items()}, N, S)
    jstep = r["coded"].make_coded_train_step(jcfg, N, S)
    from repro.optim import adamw_init as jadamw_init

    jnew, _, jm = jax.jit(jstep)(jparams, jadamw_init(jparams), jcoded, jw)
    tw = gc_round_weights(make_gradient_code(N, S, prefer_rep=False), SURVIVORS)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    tcoded = gc_chunked_batch({k: torch.from_numpy(v) for k, v in batch.items()}, N, S)
    tnew, _, tm_ = make_coded_train_step(tcfg, N, S)(tparams, adamw_init(tparams), tcoded, tw)
    assert float(tm_["loss"]) == pytest.approx(float(jm["loss"]), abs=LOSS_TOL)
    _close_trees(tnew, _port(jax.tree.map(np.asarray, jnew), tcfg), **CODED_GRAD_TOL)


@pytest.mark.parametrize("arch", [AUDIO, VLM])
def test_coded_gradient_equals_the_full_batch_gradient(arch):
    """The decode identity at (4, 1)-GC with a straggler: the weighted coded
    loss's value and gradient equal ``loss_fn``'s over the whole batch
    (aux weight 0), in the port alone."""
    cfg = tcfgs.get_smoke(arch)
    import repro_torch.models as tm

    params = tm.init_params(cfg, torch.Generator().manual_seed(5))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, N * CHUNK_BS, seed=6).items()}
    w = gc_round_weights(make_gradient_code(N, S, prefer_rep=False), SURVIVORS)
    loss, got = value_and_grad(
        lambda p: coded_loss(p, cfg, gc_chunked_batch(batch, N, S), w, N), params)
    want_loss, want = value_and_grad(lambda p: loss_fn(p, cfg, batch, aux_weight=0.0), params)
    assert float(loss) == pytest.approx(float(want_loss), abs=LOSS_TOL)
    _close_trees(got, want, **CODED_GRAD_TOL)


# -- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


# b, hq, hkv, sq, sk, causal, window, valid_k at head dim 256
# (tests/test_torch_vlm_audio.py's DH256_EDGES but the served prefill): single-
# row and ragged q tiles, sq != sk with valid_k < sk, windows, GQA groups 1 to
# 8, non-causal, rows left without a key; and paligemma's coded step's MQA 8/1
# over 256 patches + 64 text positions, cut to 4 sequences
DH256_BWD_CASES = [
    (2, 4, 2, 64, 64, True, 0, None),
    *[(2, 8, 1, sq, sq, True, 0, None) for sq in (1, 33, 64, 500)],
    (2, 8, 1, 100, 300, False, 0, 250),
    (2, 7, 1, 300, 180, True, 0, 150),
    (2, 8, 2, 200, 77, False, 0, None),
    *[(1, 4, 2, 256, 256, True, w, None) for w in (32, 96, 200)],
    *[(2, 2 * group, 2, 130, 130, True, 0, None) for group in (1, 2, 7, 8)],
    *[(1, 4, 2, 300, 300, causal, 32, 100) for causal in (False, True)],
    (4, 8, 1, 320, 320, True, 0, None),
]


def _qkv_do(dev, dtype, b, hq, hkv, sq, sk, seed):
    """q, k, v and dO as (b, h, s, 256) views of (b, s, h, 256) buffers, as
    the model passes them."""
    rng = np.random.default_rng(seed)
    shapes = ((b, sq, hq), (b, sk, hkv), (b, sk, hkv), (b, sq, hq))
    return [torch.from_numpy(rng.standard_normal((*s, 256)).astype(np.float32))
            .to(dev, dtype).transpose(1, 2) for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,causal,window,valid_k", DH256_BWD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernel_matches_autograd_at_head_dim_256(cuda_device, b, hq, hkv, sq, sk,
                                                          causal, window, valid_k, dtype):
    """dQ, dK and dV of the kernels (one wrapper call) against autograd of
    the plain version on the same inputs, within ``ATTN_TOL``."""
    td = getattr(torch, dtype)
    q, k, v, do = _qkv_do(cuda_device, td, b, hq, hkv, sq, sk, seed=7)
    kw = dict(causal=causal, window=window, valid_k=valid_k)
    out, lse = fa_kernel(q, k, v, return_lse=True, **kw)
    before = fa_bwd.launches
    got = fa_bwd(q, k, v, out, lse, do, **kw)
    assert fa_bwd.launches == before + 1
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(fa_ref.attention(*leaves, **kw), leaves, do)
    tol = ATTN_TOL[dtype]
    for a, bb in zip(got, want):
        torch.testing.assert_close(a.float(), bb.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernel_at_head_dim_256_is_bit_identical_on_rerun(cuda_device, dtype):
    """No atomics: two calls on the same inputs give the same bits."""
    td = getattr(torch, dtype)
    q, k, v, do = _qkv_do(cuda_device, td, 4, 8, 1, 320, 320, seed=8)
    out, lse = fa_kernel(q, k, v, return_lse=True)
    first = fa_bwd(q, k, v, out, lse, do)
    second = fa_bwd(q, k, v, out, lse, do)
    for a, bb in zip(first, second):
        assert torch.equal(a, bb)


@pytest.mark.cuda
def test_card_smoke_coded_gradient_at_head_dim_256_matches_the_cpu(cuda_device):
    """paligemma SMOKE at head dim 256: the f32 coded gradient ((4, 1)-GC,
    worker 2 straggling) through the kernels on the card against the CPU's
    plain path, from the same parameters and batch."""
    import repro_torch.models as tm

    cfg = tcfgs.get_smoke(VLM).replace(head_dim=256)
    params = tm.init_params(cfg, torch.Generator().manual_seed(9))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, N * CHUNK_BS, seed=10).items()}
    w = gc_round_weights(make_gradient_code(N, S, prefer_rep=False), SURVIVORS)
    coded = gc_chunked_batch(batch, N, S)
    before = (fa_kernel.launches, fa_bwd.launches)
    card_params, card_coded = (tree_map(lambda t: t.to(cuda_device), t) for t in (params, coded))
    loss, got = value_and_grad(
        lambda p: coded_loss(p, cfg, card_coded, w.to(cuda_device), N), card_params)
    L = cfg.num_layers  # each layer body rematerialised: its forward runs again
    assert (fa_kernel.launches, fa_bwd.launches) == (before[0] + 2 * L, before[1] + L)
    want_loss, want = value_and_grad(lambda p: coded_loss(p, cfg, coded, w, N), params)
    assert float(loss) == pytest.approx(float(want_loss), abs=LOSS_TOL)
    _close_trees(got, want, **CODED_GRAD_TOL)
