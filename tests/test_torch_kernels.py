"""The port's kernels (``repro_torch.kernels``).

On the CPU: each plain PyTorch version is held against the JAX package's
Pallas kernel (interpret mode) and its jnp reference, on the shapes and at
the tolerances of ``tests/test_kernels.py``, and the plain versions'
autograd gradients against ``jax.grad`` of the reference.  On the card
(``-m cuda``, skipped without one): each CUDA kernel, forward and backward,
is held against its plain version.
The JAX package is imported inside the tests that use it, so that the card
tests also run where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.gc import GradientCode
from repro_torch.kernels.flash_attention.flash_attention import aligned16
from repro_torch.kernels.flash_attention.flash_attention import flash_attention as fa_kernel
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_bwd as fa_bwd
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.gc_coding import ops as gc_ops
from repro_torch.kernels.gc_coding import ref as gc_ref
from repro_torch.kernels.gc_coding.gc_coding import coded_combine as gc_kernel
from repro_torch.kernels.gate_window import gate_window as gw_kernel
from repro_torch.kernels.gate_window import ops as gw_ops
from repro_torch.kernels.gate_window import ref as gw_ref
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.kernels.rmsnorm import ref as rn_ref
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm as rn_kernel
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_bwd as rn_bwd
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_intra_chunk as ssd_kernel

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
RMSNORM_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
ATTN_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
GC_TOL = {"float32": 1e-5, "bfloat16": 3e-2}     # tests/test_kernels.py
# f32 gradients: the packages sum in other orders, over up to ~4000 rows
GRAD_TOL = 1e-4


def _randn(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax():
    """(jax.numpy, the JAX package's rmsnorm and flash_attention modules)."""
    import jax.numpy as jnp
    from repro.kernels import flash_attention, rmsnorm

    return jnp, rmsnorm, flash_attention


def _vjp(fn, primals, cotangent):
    """jax.vjp of fn at the numpy primals, for the numpy cotangent, as numpy."""
    import jax
    import jax.numpy as jnp

    _, pull = jax.vjp(fn, *(jnp.asarray(a) for a in primals))
    return [np.asarray(g) for g in pull(jnp.asarray(cotangent))]


def _torch_vjp(fn, primals, cotangent, device="cpu"):
    """torch autograd's vjp of fn at the primals, for the cotangent."""
    xs = [torch.from_numpy(a).to(device).requires_grad_(True) for a in primals]
    out = fn(*xs)
    grads = torch.autograd.grad(out, xs, torch.from_numpy(cotangent).to(device, out.dtype))
    return out, grads


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
    # zamba2-2.7b's head dim 80 (hq = hkv), ragged, a window, bf16
    *[(1, 4, 4, 256, 256, 80, causal, 0, "float32") for causal in (True, False)],
    (1, 4, 2, 200, 200, 80, True, 64, "float32"),
    (1, 4, 4, 128, 128, 80, True, 0, "bfloat16"),
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


# -- gc_coding: plain version vs the JAX package ---------------------------------


@pytest.mark.parametrize("k", [1, 3, 16, 28])
@pytest.mark.parametrize("d", [128, 1000, 16384, 40000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_coded_combine_plain_matches_jax(k, d, dtype):
    parts, w = _randn(6, (k, d), (k,))
    jp, tp = _both(parts, dtype)
    jw, tw = _both(w, "float32")
    got = gc_ops.coded_combine(tp, tw)
    assert got.shape == (d,) and got.dtype == tp.dtype
    from repro.kernels import gc_coding as jgc

    jnp = _jax()[0]
    tol = GC_TOL[dtype]
    _close(_np(got), jgc.ops.coded_combine(jp, jw, interpret=True).astype(jnp.float32), tol)
    _close(_np(got), jgc.ref.coded_combine(jp, jw).astype(jnp.float32), tol)


def test_coded_combine_tree_plain_matches_jax_ref():
    from repro.kernels import gc_coding as jgc

    shapes = {"wte": (5, 64, 32), "bias": (5, 17), "scalar": (5,)}
    arrays = dict(zip(shapes, _randn(7, *shapes.values())))
    (w,) = _randn(8, (5,))
    jnp = _jax()[0]
    want = jgc.ref.coded_combine_tree({k: jnp.asarray(a) for k, a in arrays.items()},
                                      jnp.asarray(w))
    tree = {k: torch.from_numpy(a) for k, a in arrays.items()}
    for got in (gc_ops.coded_combine_tree(tree, torch.from_numpy(w)),
                gc_ref.coded_combine_tree(tree, torch.from_numpy(w))):
        assert set(got) == set(want)
        for name in want:
            assert got[name].shape == tuple(want[name].shape)
            _close(_np(got[name]), want[name], 1e-5)


# -- gate_window: plain version vs the JAX package (integer-only: exact) ---------

GW_CELLS, GW_N = (1, 5, 37), (7, 33, 130)
GW_DTYPES = {"window": (torch.int32,) * 3 + (torch.bool,),
             "buffer": (torch.bool, torch.int32, torch.bool, torch.bool)}


def _gw_windows(seed, rows, p=0.3):
    """Random bool windows over every (cells, n) of the sweep."""
    rng = np.random.default_rng(seed)
    return [rng.random((cells, rows, n)) < p for cells in GW_CELLS for n in GW_N]


def _gw_equal(got, want, which):
    assert len(got) == len(want) == 4
    for g, w, dt in zip(got, want, GW_DTYPES[which]):
        assert g.dtype == dt and tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_array_equal(g.cpu().numpy(), np.asarray(w))


@pytest.mark.parametrize("W", [1, 2, 3, 5])
@pytest.mark.parametrize("B", [1, 2, 3, "W"])
def test_window_stats_plain_matches_jax(W, B):
    """Against the JAX package's own statistics of the same numpy windows."""
    from repro.core.straggler import _window_stats

    B = W if B == "W" else B
    for win in _gw_windows(10 * W + B, W):
        _gw_equal(gw_ops.window_stats(torch.from_numpy(win), B), _window_stats(win, B), "window")


@pytest.mark.parametrize("kh", [0, 1, 2, 3])
@pytest.mark.parametrize("B", [1, 2, 3, "W"])
def test_buffer_stats_plain_matches_jax(kh, B):
    from repro.core.straggler import _buffer_stats

    B = kh + 1 if B == "W" else B  # the window is the buffer plus the candidate row
    for buf in _gw_windows(20 * kh + B, kh):
        _gw_equal(gw_ops.buffer_stats(torch.from_numpy(buf), B), _buffer_stats(buf, B), "buffer")


@pytest.mark.parametrize("which,cells,rows,n,B", [
    ("window", 1, 1, 7, 1), ("window", 37, 3, 130, 2), ("window", 5, 5, 33, 5),
    ("buffer", 5, 1, 33, 1), ("buffer", 37, 3, 130, 2), ("buffer", 1, 2, 7, 3),
])
def test_gate_window_plain_matches_pallas(which, cells, rows, n, B):
    """Against the Pallas kernels in interpret mode and their jnp reference."""
    import jax.numpy as jnp
    from repro.kernels.gate_window import ops as jops
    from repro.kernels.gate_window import ref as jref

    win = np.random.default_rng(cells + rows + n).random((cells, rows, n)) < 0.3
    got = getattr(gw_ops, f"{which}_stats")(torch.from_numpy(win), B)
    _gw_equal(got, getattr(jops, f"{which}_stats")(jnp.asarray(win), B, interpret=True), which)
    _gw_equal(got, getattr(jref, f"{which}_stats")(jnp.asarray(win), B), which)


def test_gate_window_plain_folds_specs_and_takes_views():
    """A (specs, cells, rows, n) input folds into cells; a sliced, non-contiguous
    buffer view (the gate's ``bufs[i][:, w-1-kh:]``) gives its copy's stats."""
    rng = np.random.default_rng(30)
    win = torch.from_numpy(rng.random((3, 5, 4, 33)) < 0.3)
    for which in ("window", "buffer"):
        fn = getattr(gw_ops, f"{which}_stats")
        got = fn(win, 2)
        for s in range(3):
            for g, w in zip(got, fn(win[s], 2)):
                assert g.shape[:2] == (3, 5)
                torch.testing.assert_close(g[s], w)
    view = win[0][:, 1:]
    assert not view.is_contiguous()
    for g, w in zip(gw_ops.buffer_stats(view, 2), gw_ops.buffer_stats(view.contiguous(), 2)):
        torch.testing.assert_close(g, w)


def test_gate_window_plain_counts_calls():
    win = torch.zeros(2, 3, 8, dtype=torch.bool)
    before = (gw_ref.window_stats.calls, gw_ref.buffer_stats.calls)
    gw_ops.window_stats(win, 1)
    gw_ops.buffer_stats(win, 1)
    gw_ops.buffer_stats(win[None], 1)
    assert (gw_ref.window_stats.calls, gw_ref.buffer_stats.calls) == (before[0] + 1,
                                                                      before[1] + 2)


def test_coded_combine_is_gc_decode():
    """The port's own GradientCode and coded combine decode a real (8, 3) encode."""
    code = GradientCode(8, 3, seed=0)
    (g,) = _randn(9, (8, 512))
    ell = torch.from_numpy(code.encode_matrix.astype(np.float32)) @ torch.from_numpy(g)
    beta = code.decode_vector([0, 2, 3, 5, 7])
    out = gc_ops.coded_combine(ell, beta)
    _close(out.numpy(), g.sum(0), 1e-4)


# -- gradients of the plain versions vs jax.grad of the reference ----------------


@pytest.mark.parametrize("shape", [(8, 256), (2, 3, 896), (130, 640), (4000, 64)])
def test_rmsnorm_plain_grad_matches_jax(shape):
    x, g, dy = _randn(10, shape, shape[-1:], shape)
    jrn = _jax()[1]
    want = _vjp(lambda a, b: jrn.ref.rmsnorm(a, b), (x, g), dy)
    _, got = _torch_vjp(lambda a, b: rn_ops.rmsnorm(a, b), (x, g), dy)
    for a, b in zip(got, want):
        _close(_np(a), b, GRAD_TOL)


GRAD_CASES = [  # b, hq, hkv, sq, sk, dh, causal, window: tests/test_kernels.py's shapes
    (1, 4, 2, 256, 256, 64, True, 0),
    (2, 8, 8, 128, 128, 32, False, 0),
    (1, 8, 1, 128, 256, 64, False, 0),
    (1, 4, 4, 384, 384, 128, True, 0),
    (1, 4, 2, 256, 256, 64, True, 96),
    (1, 14, 2, 200, 200, 64, True, 0),
    (1, 4, 4, 256, 256, 80, True, 0),
    (1, 4, 2, 200, 200, 80, False, 0),
]


@pytest.mark.parametrize("b,hq,hkv,sq,sk,dh,causal,window", GRAD_CASES)
def test_attention_plain_grad_matches_jax(b, hq, hkv, sq, sk, dh, causal, window):
    """Autograd of the plain version against jax.grad of the reference's
    online-softmax ``_chunked_attention``, scanned in 128-key blocks."""
    from repro.models.layers import _chunked_attention

    q, k, v, do = _randn(11, (b, hq, sq, dh), (b, hkv, sk, dh), (b, hkv, sk, dh),
                         (b, hq, sq, dh))
    want = _vjp(lambda a, bb, c: _chunked_attention(a, bb, c, causal=causal, window=window,
                                                    block_k=128), (q, k, v), do)
    _, got = _torch_vjp(lambda a, bb, c: fa_ops.attention(a, bb, c, causal=causal,
                                                          window=window), (q, k, v), do)
    for a, bb in zip(got, want):
        _close(_np(a), bb, ATTN_TOL["float32"])


# -- wrappers refuse what the kernels do not take --------------------------------


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch on CUDA tensors or raise: no plain fallback."""
    before = (rn_kernel.launches, fa_kernel.launches, ssd_kernel.launches)
    with pytest.raises(ValueError, match="CUDA"):
        rn_kernel(torch.ones(4, 64), torch.ones(64))
    q = torch.ones(1, 2, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel(q, q, q)
    with pytest.raises(ValueError, match="head_dim"):
        fa_kernel(torch.ones(1, 2, 8, 48), torch.ones(1, 2, 8, 48), torch.ones(1, 2, 8, 48))
    x, dt, bc = torch.ones(2, 16, 3, 8), torch.ones(2, 16, 3), torch.ones(2, 16, 5)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel(x, dt, dt, bc, bc)
    assert (rn_kernel.launches, fa_kernel.launches, ssd_kernel.launches) == before


def test_attention_wrappers_refuse_head_dims_the_kernels_do_not_take():
    """The forward takes head dims 32, 64, 80, 128 and 256 and refuses 48 and
    512; the backward refuses 256 (paligemma-3b's), naming ROADMAP B-2b.  Each
    raises before any device check or launch, and nothing falls back."""
    before = (fa_kernel.launches, fa_bwd.launches)
    for dh in (48, 512):
        q = torch.ones(1, 2, 8, dh)
        with pytest.raises(ValueError, match=rf"head_dim in \(32, 64, 80, 128, 256\), got {dh}"):
            fa_kernel(q, q, q)
    q, lse = torch.ones(1, 2, 8, 256), torch.ones(1, 2, 8)
    with pytest.raises(ValueError, match=r"head_dim in \(32, 64, 80, 128\), got 256.*B-2b"):
        fa_bwd(q, q, q, q, lse, q)
    with pytest.raises(ValueError, match="CUDA"):  # 256 passes the forward's check
        fa_kernel(q, q, q)
    assert (fa_kernel.launches, fa_bwd.launches) == before


def test_backward_and_combine_wrappers_refuse_cpu_tensors():
    before = (gc_kernel.launches, rn_bwd.launches, fa_bwd.launches)
    with pytest.raises(ValueError, match="CUDA"):
        gc_kernel(torch.ones(3, 64), torch.ones(3))
    with pytest.raises(ValueError, match="CUDA"):
        rn_bwd(torch.ones(4, 64), torch.ones(64), torch.ones(4, 64))
    q, lse = torch.ones(1, 2, 8, 64), torch.ones(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        fa_bwd(q, q, q, q, lse, q)
    with pytest.raises(ValueError, match="no implementation"):
        gc_ops.coded_combine(torch.empty(3, 64, device="meta"), [1.0, 2.0, 3.0])
    assert (gc_kernel.launches, rn_bwd.launches, fa_bwd.launches) == before


def test_gate_window_wrappers_refuse_what_they_do_not_take():
    before = (gw_kernel.window_stats.launches, gw_kernel.buffer_stats.launches)
    win = torch.zeros(2, 3, 8, dtype=torch.bool)
    for fn in (gw_kernel.window_stats, gw_kernel.buffer_stats):
        with pytest.raises(ValueError, match="CUDA"):
            fn(win, 1)
    with pytest.raises(ValueError, match="no implementation"):
        gw_ops.window_stats(torch.empty(2, 3, 8, dtype=torch.bool, device="meta"), 1)
    with pytest.raises(ValueError, match="bool"):
        gw_ops.buffer_stats(win.int(), 1)
    assert (gw_kernel.window_stats.launches, gw_kernel.buffer_stats.launches) == before

def test_aligned16_reads_the_pointer_and_the_strides():
    """The bf16 kernels' 16-byte row rule: the data pointer and every (b, h, s)
    stride over more than one index, in bytes; a size-1 dim's stride is free."""
    x = torch.zeros(2, 64, 4, 64, dtype=torch.bfloat16)
    assert aligned16(x) and aligned16(x.transpose(1, 2))
    assert not aligned16(torch.zeros(x.numel() + 1, dtype=torch.bfloat16)[1:].view(x.shape))
    assert not aligned16(torch.zeros(2, 64, 257, dtype=torch.bfloat16)[..., :256]
                         .view(2, 64, 4, 64).transpose(1, 2))
    assert aligned16(torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16).expand(1, 1, 1, 64))
    assert not aligned16(torch.zeros(1, 2, 3, 66, dtype=torch.bfloat16)[..., :64])
    assert aligned16(torch.zeros(1, 2, 3, 68, dtype=torch.float32)[..., :64])


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


# bf16, the tensor-core kernels: head dims 32/64/80/128, ragged and single-row
# queries, sq != sk, windows, GQA groups 1, 2, 7 and 8, non-causal
ATTN_BF16_CASES = [
    *[(2, 4, 2, 64, 64, dh, True, 0, "bfloat16") for dh in (32, 64, 80, 128)],
    *[(2, 4, 4, sq, sq, 80, True, 0, "bfloat16") for sq in (1, 33, 500)],
    (2, 8, 2, 200, 77, 80, False, 0, "bfloat16"),
    (1, 4, 4, 256, 256, 80, True, 96, "bfloat16"),
    *[(2, 14, 2, sq, sq, 64, True, 0, "bfloat16") for sq in (1, 33, 64, 500)],
    (1, 8, 1, 100, 300, 64, False, 0, "bfloat16"),
    (1, 8, 1, 300, 100, 32, True, 0, "bfloat16"),
    (2, 8, 2, 200, 77, 128, False, 0, "bfloat16"),
    *[(1, 4, 2, 256, 256, 64, True, w, "bfloat16") for w in (32, 96, 200)],
    (1, 4, 2, 256, 256, 128, False, 96, "bfloat16"),
    *[(2, 2 * group, 2, 130, 130, 64, True, 0, "bfloat16") for group in (1, 2, 7, 8)],
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,hq,hkv,sq,sk,dh,causal,window,dtype",
    ATTN_CASES + ATTN_BF16_CASES + [(8, 14, 2, 500, 500, 64, True, 0, "bfloat16"),
                                    (8, 32, 32, 500, 500, 80, True, 0, "bfloat16"),
                                    (2, 14, 2, 33, 33, 64, True, 0, "float32"),
                                    (2, 4, 4, 33, 33, 80, True, 0, "float32"),
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


# b, hq, hkv, sq, sk, dh, window, valid_k, dtype: keys past valid_k masked;
# with window 32 and valid_k 100, queries from 131 on see no key at all
VALID_K_CASES = [
    (1, 4, 2, 256, 256, 64, 0, 200, "float32"),
    (1, 4, 2, 256, 256, 64, 0, 200, "bfloat16"),
    (2, 14, 2, 100, 300, 64, 0, 250, "bfloat16"),
    (2, 7, 1, 300, 180, 128, 0, 150, "bfloat16"),
    (1, 4, 2, 300, 300, 64, 32, 100, "bfloat16"),
    (1, 4, 2, 300, 300, 32, 32, 100, "float32"),
    (1, 4, 4, 256, 256, 80, 0, 200, "float32"),
    (1, 4, 2, 300, 300, 80, 32, 100, "bfloat16"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,dh,window,valid_k,dtype", VALID_K_CASES)
def test_attention_kernel_valid_k(cuda_device, b, hq, hkv, sq, sk, dh, window, valid_k, dtype):
    q, k, v = _randn(5, (b, sq, hq, dh), (b, sk, hkv, dh), (b, sk, hkv, dh))
    q, k, v = (torch.from_numpy(a).to(cuda_device, DTYPES[dtype]).transpose(1, 2)
               for a in (q, k, v))
    tol = ATTN_TOL[dtype]
    for causal in (False, True):
        kw = dict(causal=causal, window=window, valid_k=valid_k)
        got, lse = fa_kernel(q, k, v, return_lse=True, **kw)
        want = fa_ref.attention(q, k, v, **kw)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        if window:  # the fully masked rows: output 0, lse +inf
            assert not got[:, :, valid_k + window - 1:].any()
            assert torch.isposinf(lse[:, :, valid_k + window - 1:]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 16, 28, 300])
@pytest.mark.parametrize("d", [128, 1000, 9610, 16384, 40000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_coded_combine_kernel_matches_plain(cuda_device, k, d, dtype):
    parts, w = _randn(12, (k, d + 1), (k,))
    tp = torch.from_numpy(parts).to(cuda_device, DTYPES[dtype])
    tw = torch.from_numpy(w).to(cuda_device)
    # k = 300 sums ten times the reference grid's terms, in another order
    tol = GC_TOL[dtype] if k <= 28 else max(GC_TOL[dtype], 1e-4)
    # aligned rows, then rows one element off alignment (the kernel's narrow path)
    for view in (tp[:, :d].contiguous(), tp.reshape(-1)[1:1 + k * d].reshape(k, d)):
        before = gc_kernel.launches
        got = gc_ops.coded_combine(view, tw)
        assert gc_kernel.launches == before + 1
        assert got.dtype == view.dtype and got.shape == (d,)
        torch.testing.assert_close(got.float(), gc_ref.coded_combine(view, tw).float(),
                                   rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4000, 896), (8192, 896), (130, 640), (1, 8192), (3, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gamma_dtype", ["float32", "bfloat16"])
def test_rmsnorm_bwd_kernel_matches_plain(cuda_device, shape, dtype, gamma_dtype):
    x, g, dy = _randn(13, shape, shape[-1:], shape)
    tx = torch.from_numpy(x).to(cuda_device, DTYPES[dtype]).requires_grad_(True)
    tg = torch.from_numpy(g).to(cuda_device, DTYPES[gamma_dtype]).requires_grad_(True)
    tdy = torch.from_numpy(dy).to(cuda_device, DTYPES[dtype])
    before = (rn_kernel.launches, rn_bwd.launches)
    got = torch.autograd.grad(rn_ops.rmsnorm(tx, tg), (tx, tg), tdy)
    assert (rn_kernel.launches, rn_bwd.launches) == (before[0] + 1, before[1] + 1)
    want = torch.autograd.grad(rn_ref.rmsnorm(tx, tg), (tx, tg), tdy)
    tol = GRAD_TOL if dtype == gamma_dtype == "float32" else RMSNORM_TOL["bfloat16"]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,hq,hkv,sq,sk,dh,causal,window,dtype",
    ATTN_CASES + ATTN_BF16_CASES + [(128, 14, 2, 64, 64, 64, True, 0, "bfloat16"),
                  (2, 32, 32, 500, 500, 80, True, 0, "bfloat16"),
                  (2, 14, 2, 33, 33, 64, True, 0, "float32"),
                  (2, 4, 4, 33, 33, 80, True, 0, "float32"),
                  (2, 8, 2, 1, 70, 32, False, 0, "float32")],
)
@pytest.mark.parametrize("strided", [False, True])
def test_attention_bwd_kernel_matches_plain(cuda_device, b, hq, hkv, sq, sk, dh, causal,
                                            window, dtype, strided):
    td = DTYPES[dtype]
    q, k, v, do = _randn(14, (b, sq, hq, dh), (b, sk, hkv, dh), (b, sk, hkv, dh),
                         (b, sq, hq, dh))
    q, k, v = (torch.from_numpy(a).to(cuda_device, td).transpose(1, 2) for a in (q, k, v))
    do = torch.from_numpy(do).to(cuda_device, td).transpose(1, 2)
    if not strided:
        q, k, v, do = q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous()
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    before = (fa_kernel.launches, fa_bwd.launches)
    got = torch.autograd.grad(fa_ops.attention(q, k, v, causal=causal, window=window),
                              (q, k, v), do)
    assert (fa_kernel.launches, fa_bwd.launches) == (before[0] + 1, before[1] + 1)
    want = torch.autograd.grad(fa_ref.attention(q, k, v, causal=causal, window=window),
                               (q, k, v), do)
    tol = ATTN_TOL[dtype]
    for a, bb in zip(got, want):
        assert a.dtype == bb.dtype and a.shape == bb.shape
        torch.testing.assert_close(a.float(), bb.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,s,dh", [(2, 4, 4, 64, 64), (128, 14, 2, 64, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_bwd_bf16_one_hot_softmax_matches_f32(cuda_device, b, hq, hkv, s, dh, causal):
    """q = k = v in bf16: each query's own key dominates its softmax, so dS =
    P (dP - D) is a near-cancellation on the diagonal and D has to be exact in
    f32.  Gradients against autograd of the f32 plain version on the same
    bf16 values, at the training shape's head layout too."""
    kv, do = _randn(18, (b, hkv, s, dh), (b, hq, s, dh))
    kv = torch.from_numpy(kv).to(cuda_device, torch.bfloat16)
    q = kv.repeat_interleave(hq // hkv, dim=1)
    do = torch.from_numpy(do).to(cuda_device, torch.bfloat16)
    leaves = [t.clone().requires_grad_(True) for t in (q, kv, kv)]
    got = torch.autograd.grad(fa_ops.attention(*leaves, causal=causal), leaves, do)
    leaves = [t.float().requires_grad_(True) for t in (q, kv, kv)]
    want = torch.autograd.grad(fa_ref.attention(*leaves, causal=causal), leaves, do.float())
    tol = ATTN_TOL["bfloat16"]
    for name, a, bb in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == bb.shape
        err = (a.float() - bb).abs().max().item()
        assert torch.allclose(a.float(), bb, rtol=tol, atol=tol), f"{name}: max_abs_err {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,dh,window,valid_k,dtype", VALID_K_CASES)
def test_attention_bwd_kernel_valid_k(cuda_device, b, hq, hkv, sq, sk, dh, window, valid_k,
                                      dtype):
    """Keys past valid_k get zero gradient and take no part in the others;
    fully masked queries get zero gradient."""
    q, k, v, do = _randn(15, (b, sq, hq, dh), (b, sk, hkv, dh), (b, sk, hkv, dh),
                         (b, sq, hq, dh))
    q, k, v, do = (torch.from_numpy(a).to(cuda_device, DTYPES[dtype]).transpose(1, 2)
                   for a in (q, k, v, do))
    tol = ATTN_TOL[dtype]
    for causal in (False, True):
        kw = dict(causal=causal, window=window, valid_k=valid_k)
        out, lse = fa_kernel(q, k, v, return_lse=True, **kw)
        got = fa_bwd(q, k, v, out, lse, do, **kw)
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
        want = torch.autograd.grad(fa_ref.attention(qq, kk, vv, **kw), (qq, kk, vv), do)
        for a, bb in zip(got, want):
            assert a.dtype == bb.dtype and a.shape == bb.shape
            torch.testing.assert_close(a.float(), bb.float(), rtol=tol, atol=tol)
        assert not got[1][:, :, valid_k:].any() and not got[2][:, :, valid_k:].any()
        if window:
            assert not got[0][:, :, valid_k + window - 1:].any()


def _device_kernel_names(fn):
    """Names of the device kernels that ``fn()`` launched, from the profiler
    (each call repeated and padded by spin kernels: the profiler can miss a
    session's first and last activities)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(16):
            torch.cuda._sleep(1000)
        for _ in range(4):
            fn()
        for _ in range(16):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    return {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_dtype_picks_its_kernels(cuda_device, dtype):
    """f32 runs the f32 CUDA-core kernels (and matches at the f32 tolerance);
    bf16 runs the tensor-core kernels and never the f32 ones."""
    q, k, v, do = _randn(16, (2, 14, 130, 64), (2, 2, 130, 64), (2, 2, 130, 64),
                         (2, 14, 130, 64))
    q, k, v, do = (torch.from_numpy(a).to(cuda_device, DTYPES[dtype]) for a in (q, k, v, do))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    before = (fa_kernel.launches, fa_bwd.launches)
    got = torch.autograd.grad(fa_ops.attention(q, k, v), (q, k, v), do)
    assert (fa_kernel.launches, fa_bwd.launches) == (before[0] + 1, before[1] + 1)
    want = torch.autograd.grad(fa_ref.attention(q, k, v), (q, k, v), do)
    tol = ATTN_TOL[dtype]
    for a, bb in zip(got, want):
        torch.testing.assert_close(a.float(), bb.float(), rtol=tol, atol=tol)
    names = _device_kernel_names(
        lambda: torch.autograd.grad(fa_ops.attention(q, k, v), (q, k, v), do))
    bf16_names = ("attn_fwd_bf16_kernel", "attn_bwd_dq_bf16_kernel", "attn_bwd_dkdv_bf16_kernel")
    f32_names = ("attn_fwd_kernel", "attn_bwd_dq_kernel", "attn_bwd_dkdv_kernel")
    ran, other = (bf16_names, f32_names) if dtype == "bfloat16" else (f32_names, bf16_names)
    for name in ran:
        assert any(name in n for n in names), (name, names)
    for name in other:
        assert not any(name in n for n in names), (name, names)


@pytest.mark.cuda
def test_attention_wrappers_refuse_misaligned_bf16_views(cuda_device):
    """cp.async moves 16 bytes: a bf16 view one element off, or whose rows are
    257 elements apart, raises before any launch; f32 takes both; the op's
    backward copies a misaligned gradient."""
    x, *qkv = (torch.from_numpy(a).to(cuda_device).transpose(1, 2)  # (b, h, s, dh) views
               for a in _randn(17, *[(2, 64, 4, 64)] * 4))
    q_ok, k_ok, v_ok = (t.bfloat16() for t in qkv)
    n = x.numel()
    for dtype in (torch.float32, torch.bfloat16):
        shifted = torch.empty(n + 1, device=cuda_device, dtype=dtype)[1:].view(2, 4, 64, 64)
        wide = torch.empty(2, 64, 4 * 64 + 1, device=cuda_device, dtype=dtype)[..., :256]
        wide = wide.view(2, 64, 4, 64).transpose(1, 2)
        for bad in (shifted.copy_(x), wide.copy_(x)):
            if dtype == torch.float32:  # the f32 kernel takes any strides
                torch.testing.assert_close(fa_kernel(bad, bad, bad),
                                           fa_ref.attention(bad, bad, bad),
                                           rtol=ATTN_TOL["float32"], atol=ATTN_TOL["float32"])
                continue
            assert not aligned16(bad)
            before = (fa_kernel.launches, fa_bwd.launches)
            for q, k, v in ((bad, k_ok, v_ok), (q_ok, bad, v_ok), (q_ok, k_ok, bad)):
                with pytest.raises(ValueError, match="16-byte"):
                    fa_kernel(q, k, v)
            out, lse = fa_kernel(q_ok, k_ok, v_ok, return_lse=True)
            with pytest.raises(ValueError, match="16-byte"):
                fa_bwd(q_ok, k_ok, v_ok, out, lse, bad)
            assert (fa_kernel.launches, fa_bwd.launches) == (before[0] + 1, before[1])
            qq = q_ok.clone().requires_grad_(True)
            got = torch.autograd.grad(fa_ops.attention(qq, k_ok, v_ok), qq, bad)[0]
            want = torch.autograd.grad(fa_ref.attention(qq, k_ok, v_ok), qq, bad)[0]
            torch.testing.assert_close(got.float(), want.float(), rtol=ATTN_TOL["bfloat16"],
                                       atol=ATTN_TOL["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [0, 1, 2, 3, 5, 10, 32])
@pytest.mark.parametrize("B", [1, 2, 3, "rows"])
def test_gate_window_kernels_match_plain(cuda_device, rows, B):
    """Both kernels, exact, over the sweep's cells and n (n not a multiple of
    32, n < 32, one cell), the main path's (64, rows, 256), and B >= rows."""
    B = max(rows, 1) if B == "rows" else B
    rng = np.random.default_rng(40 + rows)
    for cells, n in [(c, n) for c in GW_CELLS for n in GW_N] + [(64, 256), (3000, 40)]:
        x = torch.from_numpy(rng.random((cells, rows, n)) < 0.3).to(cuda_device)
        fns = [("buffer", gw_kernel.buffer_stats, gw_ref.buffer_stats)]
        if rows:
            fns.append(("window", gw_kernel.window_stats, gw_ref.window_stats))
        for which, kernel, plain in fns:
            before = kernel.launches
            got = getattr(gw_ops, f"{which}_stats")(x, B)
            assert kernel.launches == before + 1
            _gw_equal(got, [w.cpu().numpy() for w in plain(x, B)], which)


@pytest.mark.cuda
def test_gate_window_kernels_take_views_and_specs(cuda_device):
    rng = np.random.default_rng(50)
    x = torch.from_numpy(rng.random((3, 37, 5, 130)) < 0.3).to(cuda_device)
    for which in ("window", "buffer"):
        plain = getattr(gw_ref, f"{which}_stats")
        kernel = getattr(gw_kernel, f"{which}_stats")
        for view in (x, x[1][:, 2:], x[:, :, 1:4].transpose(0, 1)[5], x[2, ::2, ::2, 1::3]):
            before = kernel.launches
            got = getattr(gw_ops, f"{which}_stats")(view, 2)
            assert kernel.launches == before + 1
            _gw_equal(got, [w.cpu().numpy() for w in plain(view, 2)], which)


@pytest.mark.cuda
def test_gate_window_kernels_refuse_wide_windows(cuda_device):
    x = torch.zeros(2, 33, 8, dtype=torch.bool, device=cuda_device)
    for fn in (gw_kernel.window_stats, gw_kernel.buffer_stats):
        with pytest.raises(ValueError, match="32 rows"):
            fn(x, 1)
