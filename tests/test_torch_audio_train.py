"""hubert-xlarge's coded training against the JAX package, on the CPU in
float32, and the attention backward at its head dim on the card.

hubert-xlarge is encoder-only: its batch is seeded frame embeddings (the
stubbed audio frontend's output) and per-frame labels, its attention
non-causal at head dim 80.  From the same numpy inputs and converted SMOKE
parameters, one ``make_coded_train_step`` step ((4, 1)-GC, worker 2
straggling, the cyclic code) against the reference's step: its loss and
every parameter after the AdamW update, within ``CODED_GRAD_TOL`` (rtol 2e-3,
atol 1e-4, as ``tests/test_torch_vlm_train.py``), losses within 1e-4.  At
SMOKE's head dim 64 and at hubert's own 80.

On the card (``-m cuda``, skipped without one): q = k = v in bf16 at head
dim 80 over more than one 64-key tile, non-causal as hubert runs it (and
causal), against autograd of the f32 plain version: the dq kernel's two
passes over the key tiles.  The JAX package is imported inside the fixture
that uses it.
"""

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
from repro_torch.convert import params_from_jax
from repro_torch.core import make_gradient_code
from repro_torch.data import gc_chunked_batch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.optim import adamw_init
from repro_torch.train import gc_round_weights, make_coded_train_step
from repro_torch.tree import tree_leaves

AUDIO = "hubert-xlarge"
CODED_GRAD_TOL = dict(rtol=2e-3, atol=1e-4)
LOSS_TOL = 1e-4
N, S, CHUNK_BS, SURVIVORS = 4, 1, 2, [0, 1, 3]
FRAMES = 24
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
    import repro.optim
    import repro.train.coded

    return jax, jnp, {"configs": repro.configs, "core": repro.core, "data": repro.data,
                      "models": repro.models, "optim": repro.optim,
                      "coded": repro.train.coded}


@pytest.mark.parametrize("head_dim", [64, 80])
def test_coded_step_matches_the_reference_step(ref, head_dim):
    """One coded step of hubert SMOKE on frames and per-frame labels: the
    loss and every updated parameter as the JAX package's step gives them."""
    jax, jnp, r = ref
    jcfg = r["configs"].get_smoke(AUDIO).replace(head_dim=head_dim)
    tcfg = tcfgs.get_smoke(AUDIO).replace(head_dim=head_dim)
    tree = jax.tree.map(np.asarray, r["models"].init_params(jcfg, jax.random.PRNGKey(4)))
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_jax(tree, tcfg, device="cpu")
    rng = np.random.default_rng(5)
    b = N * CHUNK_BS
    batch = {"frames": rng.standard_normal((b, FRAMES, tcfg.d_model)).astype(np.float32),
             "labels": rng.integers(0, tcfg.vocab_size, (b, FRAMES)).astype(np.int32)}
    jw = r["coded"].gc_round_weights(r["core"].make_gradient_code(N, S, prefer_rep=False),
                                     SURVIVORS)
    jcoded = r["data"].gc_chunked_batch({k: jnp.asarray(v) for k, v in batch.items()}, N, S)
    jnew, _, jm = jax.jit(r["coded"].make_coded_train_step(jcfg, N, S))(
        jparams, r["optim"].adamw_init(jparams), jcoded, jw)
    tw = gc_round_weights(make_gradient_code(N, S, prefer_rep=False), SURVIVORS)
    tcoded = gc_chunked_batch({k: torch.from_numpy(v) for k, v in batch.items()}, N, S)
    tnew, _, tm = make_coded_train_step(tcfg, N, S)(tparams, adamw_init(tparams), tcoded, tw)
    assert np.isfinite(float(tm["loss"]))
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), abs=LOSS_TOL)
    want = tree_leaves(params_from_jax(jax.tree.map(np.asarray, jnew), tcfg, device="cpu",
                                       dtype=torch.float32))
    got = tree_leaves(tnew)
    assert len(got) == len(want)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.detach().float().numpy(), w.numpy(), **CODED_GRAD_TOL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s", [(2, 4, 200), (8, 16, 500)])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_bwd_bf16_one_hot_softmax_at_head_dim_80(cuda_device, b, h, s, causal):
    """q = k = v in bf16 at head dim 80 over 4 and 8 key tiles: each query's
    own key dominates its softmax, so dS = P (dP - D) nearly cancels on the
    diagonal and D must be exact in f32 across the dq kernel's passes."""
    rng = np.random.default_rng(19)
    kv = torch.from_numpy(rng.standard_normal((b, h, s, 80)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    do = torch.from_numpy(rng.standard_normal((b, h, s, 80)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    leaves = [kv.clone().requires_grad_(True) for _ in range(3)]
    got = torch.autograd.grad(fa_ops.attention(*leaves, causal=causal), leaves, do)
    leaves = [kv.float().requires_grad_(True) for _ in range(3)]
    want = torch.autograd.grad(fa_ref.attention(*leaves, causal=causal), leaves, do.float())
    tol = ATTN_TOL["bfloat16"]
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape
        err = (a.float() - w).abs().max().item()
        assert torch.allclose(a.float(), w, rtol=tol, atol=tol), f"{name}: max_abs_err {err}"
