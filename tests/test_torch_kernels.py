"""The port's kernels (``repro_torch.kernels``).

On the CPU: each plain PyTorch version is held against the JAX package's
Pallas kernel (interpret mode) and its jnp reference, on the shapes and at
the tolerances of ``tests/test_kernels.py``.  On the card (``-m cuda``,
skipped without one): each CUDA kernel is held against its plain version.
The JAX package is imported inside the tests that use it, so that the card
tests also run where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.kernels.rmsnorm import ref as rn_ref
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm as rn_kernel

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
RMSNORM_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
ATTN_TOL = {"float32": 2e-4, "bfloat16": 3e-2}


def _randn(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax():
    """(jax.numpy, the JAX package's rmsnorm and flash_attention modules)."""
    import jax.numpy as jnp
    from repro.kernels import flash_attention, rmsnorm

    return jnp, rmsnorm, flash_attention


def _both(a, dtype):
    """The same numpy values as a JAX array and a torch tensor of ``dtype``."""
    jnp = _jax()[0]
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(a).to(DTYPES[dtype])


def _close(got, want, tol):
    np.testing.assert_allclose(
        np.asarray(got, dtype=np.float32), np.asarray(want, dtype=np.float32),
        rtol=tol, atol=tol,
    )


def _np(t):
    return t.float().cpu().numpy()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


# -- rmsnorm: plain version vs the JAX package ---------------------------------


@pytest.mark.parametrize(
    "shape", [(8, 256), (512, 1024), (2, 3, 896), (1, 8192), (130, 640)]
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_jax(shape, dtype):
    x, g = _randn(0, shape, shape[-1:])
    jx, tx = _both(x, dtype)
    jg, tg = _both(g, "float32")
    got = rn_ops.rmsnorm(tx, tg)  # a CPU tensor takes the plain version
    assert got.shape == tx.shape and got.dtype == tx.dtype
    tol = RMSNORM_TOL[dtype]
    jnp, jrn, _ = _jax()
    _close(_np(got), jrn.ops.rmsnorm(jx, jg, interpret=True).astype(jnp.float32), tol)
    _close(_np(got), jrn.ref.rmsnorm(jx, jg).astype(jnp.float32), tol)


# -- attention: plain version vs the JAX package --------------------------------

ATTN_CASES = [
    # b, hq, hkv, sq, sk, dh, causal, window, dtype
    *[(*s, causal, 0, "float32")
      for s in [(1, 4, 2, 256, 256, 64), (2, 8, 8, 128, 128, 32),
                (1, 8, 1, 128, 256, 64), (1, 4, 4, 384, 384, 128)]
      for causal in (True, False)],
    *[(1, 4, 2, 256, 256, 64, True, w, "float32") for w in (32, 96, 200)],
    (1, 2, 2, 200, 200, 64, False, 0, "float32"),    # ragged, non-causal
    (1, 4, 2, 128, 128, 64, True, 0, "bfloat16"),
    (1, 14, 2, 200, 200, 64, True, 0, "float32"),    # qwen2-0.5b's GQA grouping
]


@pytest.mark.parametrize("b,hq,hkv,sq,sk,dh,causal,window,dtype", ATTN_CASES)
def test_attention_plain_matches_jax(b, hq, hkv, sq, sk, dh, causal, window, dtype):
    q, k, v = _randn(1, (b, hq, sq, dh), (b, hkv, sk, dh), (b, hkv, sk, dh))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    got = fa_ops.attention(tq, tk, tv, causal=causal, window=window)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    tol = ATTN_TOL[dtype]
    jnp, _, jfa = _jax()
    want = jfa.ops.attention(jq, jk, jv, causal=causal, window=window,
                             interpret=True, force_kernel=True)
    _close(_np(got), want.astype(jnp.float32), tol)
    _close(_np(got), jfa.ref.attention(jq, jk, jv, causal=causal, window=window)
           .astype(jnp.float32), tol)


def test_attention_plain_valid_k_masks_trailing_keys():
    """valid_k=n over padded keys equals attention over the first n keys."""
    q, k, v = (torch.from_numpy(a) for a in
               _randn(2, (1, 4, 256, 64), (1, 2, 256, 64), (1, 2, 256, 64)))
    got = fa_ref.attention(q, k, v, causal=False, valid_k=200)
    want = fa_ref.attention(q, k[:, :, :200], v[:, :, :200], causal=False)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# -- wrappers refuse what the kernels do not take --------------------------------


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch on CUDA tensors or raise: no plain fallback."""
    before = (rn_kernel.launches, fa_kernel.launches)
    with pytest.raises(ValueError, match="CUDA"):
        rn_kernel(torch.ones(4, 64), torch.ones(64))
    q = torch.ones(1, 2, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel(q, q, q)
    with pytest.raises(ValueError, match="head_dim"):
        fa_kernel(torch.ones(1, 2, 8, 48), torch.ones(1, 2, 8, 48), torch.ones(1, 2, 8, 48))
    assert (rn_kernel.launches, fa_kernel.launches) == before


def test_ops_refuse_devices_without_an_implementation():
    x = torch.empty(4, 64, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        rn_ops.rmsnorm(x, torch.empty(64, device="meta"))
    q = torch.empty(1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        fa_ops.attention(q, q, q)


# -- on the card: kernels vs plain versions --------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4000, 896), (8, 896), (130, 640), (1, 8192), (3, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gamma_dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_matches_plain(cuda_device, shape, dtype, gamma_dtype):
    x, g = _randn(3, shape, shape[-1:])
    tx = torch.from_numpy(x).to(cuda_device, DTYPES[dtype])
    tg = torch.from_numpy(g).to(cuda_device, DTYPES[gamma_dtype])
    before = rn_kernel.launches
    got = rn_ops.rmsnorm(tx, tg)
    assert rn_kernel.launches == before + 1
    assert got.dtype == tx.dtype and got.shape == tx.shape
    tol = RMSNORM_TOL[dtype]
    torch.testing.assert_close(got.float(), rn_ref.rmsnorm(tx, tg).float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,hq,hkv,sq,sk,dh,causal,window,dtype",
    ATTN_CASES + [(8, 14, 2, 500, 500, 64, True, 0, "bfloat16"),
                  (2, 14, 2, 33, 33, 64, True, 0, "float32"),
                  (2, 8, 2, 1, 70, 32, False, 0, "float32")],
)
@pytest.mark.parametrize("strided", [False, True])
def test_attention_kernel_matches_plain(cuda_device, b, hq, hkv, sq, sk, dh, causal,
                                        window, dtype, strided):
    td = DTYPES[dtype]
    q, k, v = _randn(4, (b, sq, hq, dh), (b, sk, hkv, dh), (b, sk, hkv, dh))
    q, k, v = (torch.from_numpy(a).to(cuda_device, td).transpose(1, 2) for a in (q, k, v))
    if not strided:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    before = fa_kernel.launches
    got = fa_ops.attention(q, k, v, causal=causal, window=window)
    assert fa_kernel.launches == before + 1
    want = fa_ref.attention(q, k, v, causal=causal, window=window)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_attention_kernel_valid_k(cuda_device):
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in
               _randn(5, (1, 4, 256, 64), (1, 2, 256, 64), (1, 2, 256, 64)))
    for causal in (False, True):
        got = fa_kernel(q, k, v, causal=causal, valid_k=200)
        want = fa_ref.attention(q, k, v, causal=causal, valid_k=200)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
