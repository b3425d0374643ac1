"""The bf16 SSD chunk-scan backward on the tensor cores
(``csrc/ssd_scan_bwd.cu``, ``ssd_bwd_*_bf16_kernel``): the roundings its
design makes, modelled in plain torch on the CPU, and the kernels on the card.

On the CPU, from numpy inputs made from a seed:
  * ``kernel_model``: the bf16 kernels' arithmetic.  x, B, C and dy are bf16;
    every product sums in f32; f32 operands of a product are split into bf16
    hi + lo (W in W^T dy, h_prev in G = dy . h_prev, E C in dh_prev = dy^T
    (E C), dS in dB and dC); dx, dB and dC are rounded to bf16 once.  At
    mamba2-1.3b's widths (64 heads of 64, d_state 128, Q 64, 3 batch-chunks, a
    nonzero h_prev, a padded tail) it meets ``SSD_BWD_TOL["bfloat16"]`` (3e-2
    of each output's scale, the tolerance ``chip_smoke.py`` holds the kernels
    to) against ``ref.ssd_chunk_scan_bwd``, and its f32 outputs (ddt, dcum,
    dh_prev, dD) meet ``SSD_BWD_TOL["float32"]``.  With the outputs left in
    f32, all seven meet the f32 tolerance; one bf16 rounding of W, h_prev, E C
    or dS would still meet the bf16 tolerance, which scales with each output
    (the forward's is absolute, and one rounding missed it there), but puts the
    outputs it feeds past the f32 one.  That is why the kernels split them.
  * the same model in f32, as the backward of ``ops._SSDChunkScanFn``, through
    ``models.ssm.ssd_chunked`` against ``jax.vjp`` of the JAX package's
    ``ssd_chunked`` (jnp path), and on the chunk layout against ``jax.vjp`` of
    its chunk output, within ``GRAD_TOL``: hi + lo keeps ~16 bits of each f32
    operand, and the products' sums run in another order.
On the card (``-m cuda``, skipped without one): the bf16 kernels read strided
views of the model's conv output at mamba2-1.3b's widths and refuse misaligned
ones before any launch; two calls at zamba2-2.7b's widths (80 heads of 64,
d_state 64) give the same bits; ragged Q 50 and head_dim 20 take the
element-by-element copies.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.kernels.ssd_scan import ssd_scan as ssd_kernels
from repro_torch.models import ssm as tssm
from test_torch_ssm_train import _inputs, _jax_chunk_output, _plain_scan, _scan_args

# chip_smoke.py's tolerance for the backward kernels: rtol, and atol times each
# output's largest magnitude
SSD_BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# f32 gradients against the JAX package (tests/test_torch_ssm_train.py)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
NAMES = ("dx", "ddt", "dcum", "dB", "dC", "dh_prev", "dD")
F32_OUTPUTS = ("ddt", "dcum", "dh_prev", "dD")
# (b, nc, Q, nh, hd, st, padded tail rows, A_scale): mamba2-1.3b's widths
MAMBA2 = (1, 3, 64, 64, 64, 128, 20, 1.0)


def _bf16(t):
    return t.bfloat16().float()


def _operand(t, one_rounding):
    """An f32 operand as the kernels give it to the tensor cores: bf16 hi + lo,
    or hi alone."""
    hi = _bf16(t)
    return hi if one_rounding else hi + _bf16(t - hi)


def kernel_model(xc, dtc, cum, Bc, Cc, h_prev, D, s, dy, one_rounding=()):
    """(dx, ddt, dcum, dB, dC, dh_prev, dD) as the bf16 kernels compute them:
    the operands in ``one_rounding`` ("W", "h_prev", "EC", "dS") rounded to
    bf16 once instead of split.  Inputs in the chunk layout of
    ``ref.ssd_chunk_scan_bwd``; with f32 x, B, C and dy nothing but the split
    operands is rounded."""
    b, nc, Q, nh, hd = xc.shape
    dyc = torch.zeros((b, nc * Q, nh, hd))
    dyc[:, :s] = dy.float()
    dyc = dyc.reshape(b, nc, Q, nh, hd)
    x, B, C = xc.float(), Bc.float(), Cc.float()
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool))[None, None, :, :, None]
    # exp(cum_q - cum_u), the exponent selected to -inf above the diagonal
    decay = torch.exp(torch.where(mask, cum[:, :, :, None, :] - cum[:, :, None, :, :],
                                  -torch.inf))
    W = torch.einsum("bcqs,bcus->bcqu", C, B)[..., None] * decay     # (b, nc, q, u, nh)
    wt_dy = torch.einsum("bcqun,bcqnh->bcunh", _operand(W, "W" in one_rounding), dyc)
    dx = dtc[..., None] * wt_dy + D[:, None] * dyc
    ddt = (x * wt_dy).sum(-1)
    dW = torch.where(mask, torch.einsum("bcqnh,bcunh->bcqun", dyc, x) * dtc[:, :, None], 0.0)
    dS = (dW * decay).sum(-1)
    P = dW * W
    E = torch.exp(cum)
    G = torch.einsum("bcqnh,bcnhs->bcqns", dyc, _operand(h_prev, "h_prev" in one_rounding))
    dcum = P.sum(3) - P.sum(2) + E * torch.einsum("bcqs,bcqns->bcqn", C, G)
    EC = _operand(E[..., None] * C[:, :, :, None, :], "EC" in one_rounding)
    dh_prev = torch.einsum("bcqnh,bcqns->bcnhs", dyc, EC)
    dSk = _operand(dS, "dS" in one_rounding)
    dB = torch.einsum("bcqu,bcqs->bcus", dSk, C)
    dC = torch.einsum("bcqu,bcus->bcqs", dSk, B) + torch.einsum("bcqn,bcqns->bcqs", E, G)
    dD = (dyc * x).sum((0, 1, 2, 4))
    return (dx.to(xc.dtype), ddt, dcum, dB.to(Bc.dtype), dC.to(Cc.dtype), dh_prev, dD)


def _errors(got, want):
    """Each output's largest error over its scale (its largest magnitude, at
    least 1), by name."""
    out = {}
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        scale = max(1.0, float(w.float().abs().max()))
        out[name] = float((g.float() - w.float()).abs().max()) / scale
    return out


@pytest.fixture(scope="module")
def mamba2_case():
    """Inputs at mamba2-1.3b's widths with x, B, C and dy holding bf16 values,
    as bf16 tensors and as f32 tensors (so that no output is rounded), and the
    plain backward of each."""
    np_args, s, dy = _inputs(11, *MAMBA2)
    args = [torch.from_numpy(a).to(torch.bfloat16 if i in (0, 3, 4) else torch.float32)
            for i, a in enumerate(np_args)]
    dy = torch.from_numpy(dy).bfloat16()
    f32 = [a.float() for a in args]
    return (args, dy, ssd_ref.ssd_chunk_scan_bwd(*args, s, dy)), \
        (f32, dy.float(), ssd_ref.ssd_chunk_scan_bwd(*f32, s, dy.float())), s


def test_kernel_model_meets_the_bf16_tolerance(mamba2_case):
    """bf16 in and out, as the kernels run at the training shape: within
    SSD_BWD_TOL["bfloat16"]; the f32 outputs within SSD_BWD_TOL["float32"],
    and dx, dB and dC (f32 sums rounded to bf16 once) within two bf16 ulps of
    their scale."""
    (args, dy, want), _, s = mamba2_case
    got = kernel_model(*args, s, dy)
    errs = _errors(got, want)
    assert all(torch.isfinite(g.float()).all() for g in got)
    assert all(e <= SSD_BWD_TOL["bfloat16"] for e in errs.values()), errs
    assert all(errs[name] <= SSD_BWD_TOL["float32"] for name in F32_OUTPUTS), errs
    assert all(errs[name] <= 2 ** -7 for name in ("dx", "dB", "dC")), errs


@pytest.mark.parametrize("operand,outputs", [("W", ("dx", "ddt")), ("h_prev", ("dcum", "dC")),
                                             ("EC", ("dh_prev",)), ("dS", ("dB", "dC"))])
def test_one_rounding_of_an_f32_operand_misses_the_f32_tolerance(mamba2_case, operand, outputs):
    """Outputs left in f32: with every f32 operand split, all seven outputs
    are within SSD_BWD_TOL["float32"] of the plain backward; one bf16 rounding
    of the operand still meets SSD_BWD_TOL["bfloat16"], but puts the outputs
    it feeds past the f32 tolerance."""
    _, (args, dy, want), s = mamba2_case
    split = _errors(kernel_model(*args, s, dy), want)
    assert all(e <= SSD_BWD_TOL["float32"] for e in split.values()), split
    one = _errors(kernel_model(*args, s, dy, one_rounding=(operand,)), want)
    assert all(e <= SSD_BWD_TOL["bfloat16"] for e in one.values()), one
    assert all(one[name] > SSD_BWD_TOL["float32"] for name in outputs), one


@pytest.fixture(scope="module")
def ref():
    """(jax, jax.numpy)."""
    import jax
    import jax.numpy as jnp

    return jax, jnp


# (b, nc, Q, nh, hd, st, tail, A_scale): whole chunks, a tail, Q 12, steep decay
SMALL_CASES = [(2, 3, 16, 3, 8, 5, 0, 1.0), (2, 4, 16, 2, 8, 6, 7, 1.0),
               (1, 3, 12, 2, 4, 3, 5, 1.0), (1, 2, 16, 2, 8, 4, 0, 200.0)]
STEEP = SMALL_CASES[3]


@pytest.mark.parametrize("case", SMALL_CASES)
def test_kernel_model_matches_jax_vjp_of_the_chunk_output(ref, case):
    """f32 inputs: the split model against jax.vjp of the JAX package's jnp
    chunk output (src/repro/models/ssm.py:95-140), within GRAD_TOL."""
    jax, jnp = ref
    np_args, s, dy = _inputs(12, *case)
    _, vjp = jax.vjp(_jax_chunk_output(jax, jnp, s), *(jnp.asarray(a) for a in np_args))
    want = [torch.from_numpy(np.array(g)) for g in vjp(jnp.asarray(dy))]
    got = kernel_model(*(torch.from_numpy(a) for a in np_args), s, torch.from_numpy(dy))
    for name, g, w in zip(NAMES, got, want):
        if case == STEEP and name == "dcum":
            # the JAX package's jnp gradient of cum is NaN under steep decay
            # (ROADMAP C-8); the kernels select the exponent before exp
            assert torch.isnan(w).any() and torch.isfinite(g).all()
            continue
        torch.testing.assert_close(g, w, **GRAD_TOL, msg=f"{case} {name}")


def _model_scan_bwd(x, dt, cum, B, C, h_prev, D, dy, nc, s):
    """The backward kernel entry's contract (flattened (b*nc, ...) tensors),
    computed by the model."""
    def chunked(a):
        return a.reshape((a.shape[0] // nc, nc) + a.shape[1:])

    grads = kernel_model(*(chunked(a) for a in (x, dt, cum, B, C, h_prev)), D, s, dy)
    return tuple(g.reshape((-1,) + g.shape[2:]) if g.dim() > 1 else g for g in grads)


@pytest.mark.parametrize("s", [64, 45])  # 4 whole chunks of 16; 3 and a tail
def test_ssd_chunked_through_the_model_matches_jax_vjp(ref, monkeypatch, s):
    """``ssd_chunked`` on the card's path (``_SSDChunkScanFn``) with the
    forward kernel's plain version and the model as its backward, on CPU
    tensors, against jax.vjp of the JAX package's ``ssd_chunked`` (jnp
    path): the gradients of x, dt, A, B, C and D and of the final state."""
    jax, jnp = ref
    from repro.models.ssm import ssd_chunked as jscan

    calls = []

    def bwd(*a):
        calls.append(a)
        return _model_scan_bwd(*a)

    monkeypatch.setattr(ssd_ops, "_scan_kernel", _plain_scan)
    monkeypatch.setattr(ssd_ops, "_scan_bwd_kernel", bwd)
    monkeypatch.setattr(ssd_ops, "ssd_chunk_scan", ssd_ops._kernel_path)
    args = _scan_args(20 + s, 2, s, 3, 8, 5, 1.0)
    (jy, jh), vjp = jax.vjp(lambda *a: jscan(*a, chunk=16, return_state=True),
                            *(jnp.asarray(a) for a in args))
    rng = np.random.default_rng(7)
    dy = rng.standard_normal(jy.shape).astype(np.float32)
    dh = rng.standard_normal(jh.shape).astype(np.float32)
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, h = tssm.ssd_chunked(*leaves, chunk=16, return_state=True)
    got = torch.autograd.grad((y, h), leaves, (torch.from_numpy(dy), torch.from_numpy(dh)))
    assert len(calls) == 1
    for name, g, w in zip("x dt A B C D".split(), got, want):
        torch.testing.assert_close(g, torch.from_numpy(np.array(w)), **GRAD_TOL, msg=name)


def test_backward_wrapper_refuses_cpu_tensors():
    np_args, s, dy = _inputs(13, 1, 2, 16, 2, 8, 8, 0, 1.0)
    args = [torch.from_numpy(a) for a in np_args]
    flat = [a.reshape((2,) + a.shape[2:]) for a in args[:6]]
    before = ssd_kernels.ssd_chunk_scan_bwd.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_kernels.ssd_chunk_scan_bwd(*flat, args[6], torch.from_numpy(dy), 2, s)
    assert ssd_kernels.ssd_chunk_scan_bwd.launches == before


# -- on the card ---------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _card_inputs(dev, seed, b, nc, Q, nh, hd, st, tail=0):
    """bf16 x, B, C and dy, f32 dt, cum, h_prev and D on the card, flattened to
    (b*nc, ...), and s."""
    np_args, s, dy = _inputs(seed, b, nc, Q, nh, hd, st, tail, 1.0)
    args = [torch.from_numpy(a).to(dev, torch.bfloat16 if i in (0, 3, 4) else torch.float32)
            for i, a in enumerate(np_args)]
    flat = [a.reshape((b * nc,) + a.shape[2:]) for a in args[:6]]
    return flat, args[6], torch.from_numpy(dy).to(dev, torch.bfloat16), s


def _close(got, flat, D, dy, nc, s):
    """The kernel's outputs against the plain backward, SSD_BWD_TOL["bfloat16"]
    times each output's scale."""
    chunked = [a.unflatten(0, (-1, nc)) for a in flat]
    want = ssd_ref.ssd_chunk_scan_bwd(*(a.contiguous() for a in chunked), D, s, dy)
    tol = SSD_BWD_TOL["bfloat16"]
    for name, g, w in zip(NAMES, got, want):
        g = g.reshape(w.shape)
        assert torch.isfinite(g.float()).all(), name
        scale = max(1.0, float(w.float().abs().max()))
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol * scale, msg=name)


@pytest.mark.cuda
def test_bf16_kernel_reads_views_of_the_conv_output(cuda_device):
    """mamba2-1.3b's layout: x, B and C strided slices of one (bc, Q, 64 * 64 +
    2 * 128) conv output, rows 16-byte aligned; the 16-byte copies run."""
    dev, nh, hd, st, b, nc = cuda_device, 64, 64, 128, 2, 3
    flat, D, dy, s = _card_inputs(dev, 14, b, nc, 64, nh, hd, st, tail=20)
    xbc = torch.cat([flat[0].flatten(2), flat[3], flat[4]], dim=-1)
    x = xbc[..., :nh * hd].unflatten(-1, (nh, hd))
    Bm, Cm = xbc[..., nh * hd:nh * hd + st], xbc[..., nh * hd + st:]
    assert not x.is_contiguous() and Bm.stride(1) == nh * hd + 2 * st
    assert ssd_kernels._vec_rows(x, Bm, Cm, "test")
    views = [x, flat[1], flat[2], Bm, Cm, flat[5]]
    before = ssd_kernels.ssd_chunk_scan_bwd.launches
    got = ssd_kernels.ssd_chunk_scan_bwd(*views, D, dy, nc, s)
    torch.cuda.synchronize()
    assert ssd_kernels.ssd_chunk_scan_bwd.launches == before + 1
    _close(got, views, D, dy, nc, s)


@pytest.mark.cuda
def test_bf16_kernel_refuses_misaligned_views(cuda_device):
    """A view one element off 16 bytes, a strided last dim, or a dy one element
    off raise before any launch."""
    dev, nh, hd, st, nc = cuda_device, 4, 16, 8, 2
    flat, D, dy, s = _card_inputs(dev, 15, 2, nc, 64, nh, hd, st)
    xbc = torch.zeros((4, 64, nh * hd + 2 * st + 8), device=dev, dtype=torch.bfloat16)
    shifted = xbc[..., 1:1 + nh * hd].unflatten(-1, (nh, hd))
    strided_B = xbc[..., nh * hd:nh * hd + 2 * st:2]
    dy_off = torch.zeros(dy.numel() + 1, device=dev, dtype=torch.bfloat16)[1:].view(dy.shape)
    before = ssd_kernels.ssd_chunk_scan_bwd.launches
    calls = {
        "x one element off": (shifted, *flat[1:], D, dy),
        "B's last dim strided": (*flat[:3], strided_B, *flat[4:], D, dy),
        "dy one element off": (*flat, D, dy_off),
    }
    for what, call in calls.items():
        with pytest.raises(ValueError, match="16-byte"):
            ssd_kernels.ssd_chunk_scan_bwd(*call, nc, s)
    assert ssd_kernels.ssd_chunk_scan_bwd.launches == before


@pytest.mark.cuda
def test_bf16_kernel_is_bit_identical_at_zamba2_widths(cuda_device):
    """80 heads of 64, d_state 64 (the inter launch's 64-column tile), over 8
    sequences of 4 chunks: two calls, the same bits, within tolerance."""
    flat, D, dy, s = _card_inputs(cuda_device, 16, 8, 4, 64, 80, 64, 64, tail=30)
    got = ssd_kernels.ssd_chunk_scan_bwd(*flat, D, dy, 4, s)
    again = ssd_kernels.ssd_chunk_scan_bwd(*flat, D, dy, 4, s)
    torch.cuda.synchronize()
    for name, g, a in zip(NAMES, got, again):
        assert torch.equal(g, a), name
    _close(got, flat, D, dy, 4, s)


@pytest.mark.cuda
def test_bf16_kernel_copies_ragged_rows_element_by_element(cuda_device):
    """Q 50 and head_dim 20, d_state 5: no 16-byte copies (``_vec_rows`` is
    false), the kernels still run on the tensor cores and agree."""
    flat, D, dy, s = _card_inputs(cuda_device, 17, 2, 3, 50, 3, 20, 5, tail=11)
    assert not ssd_kernels._vec_rows(flat[0], flat[3], flat[4], "test")
    before = ssd_kernels.ssd_chunk_scan_bwd.launches
    got = ssd_kernels.ssd_chunk_scan_bwd(*flat, D, dy, 3, s)
    torch.cuda.synchronize()
    assert ssd_kernels.ssd_chunk_scan_bwd.launches == before + 1
    _close(got, flat, D, dy, 3, s)
