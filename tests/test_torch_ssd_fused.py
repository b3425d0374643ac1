"""The fused SSD chunk scan (``repro_torch.kernels.ssd_scan.ssd_chunk_scan``):
the chunk's whole output, intra-chunk block, inter-chunk term, D skip and
cast, in one call.

On the CPU:
  * its plain version against the JAX package's ``ssd_chunked`` (jnp path, and
    the Pallas path in interpret mode) in f32 and with a bf16 output, over a
    few chunks, a ragged last chunk, Q not a multiple of 16 and steep decay;
  * ``ssd_chunked`` in its order (states and recurrence first, then the chunk
    output) against the JAX package, y and the final state;
  * the rounding the bf16 kernel does, modelled in f32: one bf16 rounding of
    w' = S exp(cum_q - cum_u) dt_u (or of h_prev) misses ``SSD_TOL``, the
    split hi + lo meets it;
  * the new modules import nothing of JAX or of the JAX package.
On the card (``-m cuda``, skipped without one): both kernel entries against
their plain versions on ``tests/test_torch_ssm.py``'s kernel cases, strided,
misaligned and refused views, and ``ssd_chunked`` through the fused entry.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_chunk_scan as scan_kernel
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_intra_chunk as intra_kernel
from repro_torch.models import ssm as tssm
from test_torch_ssm import KERNEL_CASES, _ssd_inputs, elsewhere

ROOT = Path(__file__).resolve().parents[1]
# tests/test_ssd_kernel.py's tolerances for the intra-chunk block
SSD_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (b, s, nh, hd, st, chunk, A_scale): whole chunks, a ragged last chunk, a
# sequence below one chunk, Q = 12 (no multiple of 16) ragged, steep decay
FUSED_CASES = [
    (2, 48, 3, 8, 5, 16, 1.0),
    (2, 37, 3, 8, 5, 16, 1.0),
    (1, 10, 2, 4, 3, 16, 1.0),
    (1, 45, 2, 16, 8, 12, 1.0),
    (2, 40, 2, 8, 6, 16, 200.0),
]


def _scan_inputs(seed, b, s, nh, hd, st, A_scale):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    dt = (rng.random((b, s, nh)) * 0.4 + 0.1).astype(np.float32)
    A = (-(rng.random(nh) + 0.2) * A_scale).astype(np.float32)
    Bm = rng.standard_normal((b, s, st)).astype(np.float32)
    Cm = rng.standard_normal((b, s, st)).astype(np.float32)
    D = rng.standard_normal(nh).astype(np.float32)
    return x, dt, A, Bm, Cm, D


def _jax_ssd_chunked(args, chunk, use_pallas, return_state=False):
    """The JAX package's ssd_chunked; its Pallas kernel in interpret mode (patched
    in as tests/test_ssd_kernel.py does)."""
    import jax.numpy as jnp
    from repro.kernels.ssd_scan import ops as jops
    from repro.models.ssm import ssd_chunked as jscan

    orig = jops.ssd_intra_chunk

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    jops.ssd_intra_chunk = interp
    try:
        out = jscan(*(jnp.asarray(a) for a in args), chunk=chunk, use_pallas=use_pallas,
                    return_state=return_state)
    finally:
        jops.ssd_intra_chunk = orig
    return [np.asarray(o) for o in out] if return_state else np.asarray(out)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# -- the plain fused version against the JAX package ------------------------------


@pytest.mark.parametrize("case", FUSED_CASES)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_fused_plain_matches_jax_ssd_chunked(case, use_pallas):
    b, s, nh, hd, st, chunk, A_scale = case
    args = _scan_inputs(7, b, s, nh, hd, st, A_scale)
    want = _jax_ssd_chunked(args, chunk, use_pallas)
    x, dt, A, Bm, Cm, D = (_t(a) for a in args)
    xc, dtc, cum, Bc, Cc, h_prev, _ = tssm._chunk_inputs(x, dt, A, Bm, Cm, chunk)
    got = ssd_ref.ssd_chunk_scan(xc, dtc, cum, Bc, Cc, h_prev, D, s)
    assert got.shape == (b, s, nh, hd) and got.dtype == torch.float32
    tol = SSD_TOL["float32"]
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    # a bf16 output: the f32 sums rounded once, as the reference's cast after them
    got = ssd_ref.ssd_chunk_scan(xc, dtc, cum, Bc, Cc, h_prev, D, s, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    tol = SSD_TOL["bfloat16"]
    want_bf16 = torch.from_numpy(np.array(want)).to(torch.bfloat16).float()
    torch.testing.assert_close(got.float(), want_bf16, rtol=tol, atol=tol)


@pytest.mark.parametrize("case", FUSED_CASES)
def test_ssd_chunked_in_its_order_matches_reference(case):
    """plain=False on the CPU: the states and recurrence first, then the chunk
    output through ``ops.ssd_chunk_scan``; y and the final state at 2e-4."""
    b, s, nh, hd, st, chunk, A_scale = case
    args = _scan_inputs(8, b, s, nh, hd, st, A_scale)
    want = _jax_ssd_chunked(args, chunk, False, return_state=True)
    for plain in (False, True):
        got = tssm.ssd_chunked(*(_t(a) for a in args), chunk=chunk, plain=plain,
                               return_state=True)
        assert got[0].dtype == torch.float32 and got[1].shape == (b, nh, hd, st)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-4)


def test_chunk_scan_op_on_the_cpu_is_its_plain_version():
    args = [_t(a) for a in _scan_inputs(9, 2, 37, 3, 8, 5, 1.0)]
    xc, dtc, cum, Bc, Cc, h_prev, _ = tssm._chunk_inputs(*args[:5], 16)
    D = args[5]
    before = scan_kernel.launches
    for out_dtype in (torch.float32, torch.bfloat16):
        got = ssd_ops.ssd_chunk_scan(xc, dtc, cum, Bc, Cc, h_prev, D, 37, out_dtype)
        want = ssd_ref.ssd_chunk_scan(xc, dtc, cum, Bc, Cc, h_prev, D, 37, out_dtype)
        assert got.dtype == out_dtype and got.shape == (2, 37, 3, 8)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert scan_kernel.launches == before
    # ssm_apply's cast happens inside: its output is already in the model dtype
    y = tssm.ssd_chunked(*args, chunk=16, out_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16


def test_chunk_scan_op_refuses_a_gradient_off_the_cpu(monkeypatch):
    """The fused entry is differentiable off the CPU: a call that needs a
    gradient goes into ``_SSDChunkScanFn`` (its backward is the kernel of
    ``csrc/ssd_scan_bwd.cu``), one that does not straight to the forward
    kernel.  A device with no implementation is still refused either way; the
    meta device takes the plain version."""
    x = elsewhere(1, 2, 16, 2, 8, requires_grad=True)
    dt, Bm = elsewhere(1, 2, 16, 2), elsewhere(1, 2, 16, 4)
    h, D = elsewhere(1, 2, 2, 8, 4), elsewhere(2)
    for args in ((x, dt, dt, Bm, Bm, h, D, 32), (x.detach(), dt, dt, Bm, Bm, h, D, 32)):
        with pytest.raises(ValueError, match="no implementation"):
            ssd_ops.ssd_chunk_scan(*args)
    meta = [torch.empty(t.shape, device="meta") for t in (x, dt, dt, Bm, Bm, h, D)]
    assert ssd_ops.ssd_chunk_scan(*meta, 32).shape == (1, 32, 2, 8)
    # past the device check, these tensors show where each call goes
    routes = []
    monkeypatch.setattr(ssd_ops, "_check_device", lambda what, device: None)
    monkeypatch.setattr(ssd_ops, "_scan_kernel", lambda *a: routes.append(("kernel", a[7:])))
    monkeypatch.setattr(ssd_ops._SSDChunkScanFn, "apply",
                        lambda *a: routes.append(("autograd", a[7:])))
    ssd_ops.ssd_chunk_scan(x, dt, dt, Bm, Bm, h, D, 32)
    ssd_ops.ssd_chunk_scan(x.detach(), dt, dt, Bm, Bm, h, D, 32, torch.bfloat16)
    with torch.no_grad():
        ssd_ops.ssd_chunk_scan(x, dt, dt, Bm, Bm, h, D, 32)
    assert routes == [("autograd", (2, 32, torch.float32)), ("kernel", (2, 32, torch.bfloat16)),
                      ("kernel", (2, 32, torch.float32))]


# -- the bf16 kernel's rounding, modelled in f32 on the CPU ------------------------


def _split(w):
    hi = w.bfloat16().float()
    return hi, (w - hi).bfloat16().float()


def test_split_bf16_operands_meet_ssd_tol_where_one_rounding_misses():
    """At mamba2-1.3b's widths (Q 64, head_dim 64, d_state 128; 4 batch-chunks
    of 16 heads) with bf16 x, B and C: one bf16 rounding of w' (as attention
    rounds P) or of h_prev misses SSD_TOL["bfloat16"]; hi + lo, two products
    on one operand each, meets it with room.  The kernel does hi + lo."""
    x, dt, cum, Bm, Cm = (torch.from_numpy(a) for a in
                          _ssd_inputs(np.random.default_rng(0), 2, 2, 64, 16, 64, 128))
    x, Bm, Cm = (t.bfloat16().float() for t in (x, Bm, Cm))
    x, dt, cum, Bm, Cm = (t.reshape((4,) + t.shape[2:]) for t in (x, dt, cum, Bm, Cm))
    tol = SSD_TOL["bfloat16"]

    def misses(got, want):
        return not torch.allclose(got, want, rtol=tol, atol=tol)

    mask = torch.tril(torch.ones(64, 64, dtype=torch.bool))
    decay = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])
    scores = torch.einsum("bqs,bus->bqu", Cm, Bm)
    w = torch.where(mask[None, :, :, None], scores[..., None] * decay, 0.0) * dt[:, None]
    want = torch.einsum("bqun,bunh->bqnh", w, x)
    torch.testing.assert_close(want, ssd_ref.ssd_intra_chunk(x, dt, cum, Bm, Cm),
                               rtol=1e-5, atol=1e-4)
    hi, lo = _split(w)
    assert misses(torch.einsum("bqun,bunh->bqnh", hi, x), want)
    assert not misses(torch.einsum("bqun,bunh->bqnh", hi, x)
                      + torch.einsum("bqun,bunh->bqnh", lo, x), want)

    h = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 16, 64, 128))
                         .astype(np.float32))
    want = torch.einsum("bqs,bnhs->bqnh", Cm, h)
    hi, lo = _split(h)
    assert misses(torch.einsum("bqs,bnhs->bqnh", Cm, hi), want)
    assert not misses(torch.einsum("bqs,bnhs->bqnh", Cm, hi)
                      + torch.einsum("bqs,bnhs->bqnh", Cm, lo), want)


def test_ssd_modules_import_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch" / "kernels" / "ssd_scan").glob("*.py"))
    files.append(ROOT / "src" / "repro_torch" / "models" / "ssm.py")
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert len(files) == 5 and not bad, bad


# -- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _card_case(case, dtype, dev, seed=0):
    """KERNEL_CASES' inputs in the chunked layout on the card, with an h_prev
    and D, and s: the last chunk ragged where there are several."""
    b, nc, Q, nh, hd, st, _, A_scale = case
    x, dt, cum, Bm, Cm = _ssd_inputs(np.random.default_rng(seed), b, nc, Q, nh, hd, st,
                                     A_scale=A_scale)
    rng = np.random.default_rng(seed + 1)
    h_prev = (0.5 * rng.standard_normal((b, nc, nh, hd, st))).astype(np.float32)
    D = rng.standard_normal(nh).astype(np.float32)
    td = DTYPES[dtype]
    xc, Bc, Cc = (torch.from_numpy(a).to(dev, td) for a in (x, Bm, Cm))
    dtc, cm, hp, Dt = (torch.from_numpy(a).to(dev) for a in (dt, cum, h_prev, D))
    s = nc * Q - (Q // 3 if nc > 1 else 0)
    return (xc, dtc, cm, Bc, Cc), hp, Dt, s


@pytest.mark.cuda
@pytest.mark.parametrize("case", KERNEL_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_entries_match_plain(cuda_device, case, dtype):
    inputs, h_prev, D, s = _card_case(case, dtype, cuda_device)
    tol = SSD_TOL[dtype]
    before = (intra_kernel.launches, scan_kernel.launches)
    got = ssd_ops.ssd_intra_chunk(*inputs)
    torch.cuda.synchronize()
    assert (intra_kernel.launches, scan_kernel.launches) == (before[0] + 1, before[1])
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    want = ssd_ops.ssd_intra_chunk(*(a.cpu() for a in inputs))
    torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol)
    outs = (torch.float32, torch.bfloat16) if dtype == "bfloat16" else (torch.float32,)
    for out_dtype in outs:
        before = scan_kernel.launches
        got = ssd_ops.ssd_chunk_scan(*inputs, h_prev, D, s, out_dtype)
        torch.cuda.synchronize()
        assert scan_kernel.launches == before + 1
        assert got.dtype == out_dtype and torch.isfinite(got.float()).all()
        want = ssd_ops.ssd_chunk_scan(*(a.cpu() for a in inputs), h_prev.cpu(), D.cpu(), s,
                                      out_dtype)
        torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_ssd_bf16_kernel_reads_views_and_refuses_misaligned_ones(cuda_device):
    """The model's layout in bf16: x, B and C strided slices of one projection
    (rows 16-byte aligned) through both entries; a view one element off, or
    with a strided last dim, raises before any launch, as do an h_prev, s or
    out_dtype the fused entry does not take."""
    dev = cuda_device
    rng = np.random.default_rng(2)
    nh, hd, st, bc = 4, 16, 8, 6
    width = nh * hd + 2 * st
    xbc = torch.from_numpy(rng.standard_normal((bc, 64, width + 8)).astype(np.float32))
    xbc = xbc.to(dev, torch.bfloat16)

    def views(off):
        x = xbc[..., off:off + nh * hd].unflatten(-1, (nh, hd))
        return x, xbc[..., off + nh * hd:off + nh * hd + st], xbc[..., off + nh * hd + st:
                                                                  off + width]

    dt = torch.from_numpy(rng.random((bc, 64, nh)).astype(np.float32) * 0.5).to(dev)
    cum = torch.cumsum(-dt, dim=1)
    h_prev = torch.from_numpy(rng.standard_normal((bc, nh, hd, st)).astype(np.float32)).to(dev)
    D = torch.ones(nh, device=dev)
    x, Bm, Cm = views(0)
    tol = SSD_TOL["bfloat16"]
    got = intra_kernel(x, dt, cum, Bm, Cm)
    want = ssd_ref.ssd_intra_chunk(x.contiguous(), dt, cum, Bm.contiguous(), Cm.contiguous())
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    got = scan_kernel(x, dt, cum, Bm, Cm, h_prev, D, 3, 150, torch.bfloat16)
    chunked = [t.unflatten(0, (2, 3)) for t in (x, dt, cum, Bm, Cm, h_prev)]
    want = ssd_ref.ssd_chunk_scan(*chunked[:5], chunked[5], D, 150, torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)

    before = (intra_kernel.launches, scan_kernel.launches)
    shifted = views(1)   # every row starts 2 bytes past a 16-byte boundary
    strided = (x, xbc[..., nh * hd:nh * hd + 2 * st:2], Cm)   # B's last dim strided
    for bad in (shifted, strided):
        with pytest.raises(ValueError, match="16-byte"):
            intra_kernel(bad[0], dt, cum, bad[1], bad[2])
        with pytest.raises(ValueError, match="16-byte"):
            scan_kernel(bad[0], dt, cum, bad[1], bad[2], h_prev, D, 3, 150)
    with pytest.raises(ValueError, match="h_prev"):
        scan_kernel(x, dt, cum, Bm, Cm, h_prev.transpose(2, 3), D, 3, 150)
    with pytest.raises(ValueError, match="sequences"):
        scan_kernel(x, dt, cum, Bm, Cm, h_prev, D, 3, 193)
    with pytest.raises(ValueError, match="out_dtype"):
        scan_kernel(x.float(), dt, cum, Bm.float(), Cm.float(), h_prev, D, 3, 150,
                    torch.bfloat16)
    assert (intra_kernel.launches, scan_kernel.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_on_card_goes_through_the_fused_entry(cuda_device, dtype):
    """One fused launch per call and none of the intra entry; y and the final
    state against ``plain=True`` on the card."""
    args = _scan_inputs(10, 2, 100, 4, 32, 16, 1.0)
    td = DTYPES[dtype]
    x, dt, A, Bm, Cm, D = (_t(a).to(cuda_device) for a in args)
    x, Bm, Cm = (t.to(td) for t in (x, Bm, Cm))
    before = (intra_kernel.launches, scan_kernel.launches)
    got = tssm.ssd_chunked(x, dt, A, Bm, Cm, D, chunk=64, return_state=True, out_dtype=td)
    assert (intra_kernel.launches, scan_kernel.launches) == (before[0], before[1] + 1)
    want = tssm.ssd_chunked(x, dt, A, Bm, Cm, D, chunk=64, return_state=True, out_dtype=td,
                            plain=True)
    tol = SSD_TOL[dtype]
    assert got[0].dtype == td
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)
