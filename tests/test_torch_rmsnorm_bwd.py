"""The RMSNorm backward kernel's design (``repro_torch/kernels/csrc/rmsnorm_bwd.cu``).

On the CPU:
  * the wrapper's plan (``rmsnorm._plan``): every width the port's configs and
    tests use gets a bucket whose team of warps covers the row, or the chunked
    path; the grid is at most two blocks an SM (all resident at once) and no
    slab is empty;
  * the kernel's dgamma reduction order, emulated in plain torch at the coded
    step's shape (8192, 896) and at other buckets: per-thread column sums over
    a team's rows of its slab, the teams in order, then after the grid barrier
    32 lanes each adding every 32nd slab in order, a butterfly over the four
    lanes of a warp, and the warps in order.  It is held to ``jax.grad`` of the
    JAX package's ``kernels/rmsnorm/ref.py`` and to autograd of the port's
    plain version at ``RMSNORM_BWD_TOL``;
  * which views take 16-byte packs.
On the card (``-m cuda``, skipped without one): dgamma bit-identical over
repeated calls, the counters right across calls of changing shape, one launch a
call, and the kernel against autograd of the plain version for d from 100 to
8192, both dtypes and both gamma dtypes.
"""

import importlib

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.kernels.rmsnorm import ref as rn_ref

# the wrapper module (the package's ``rmsnorm`` name is the public function)
rn = importlib.import_module("repro_torch.kernels.rmsnorm.rmsnorm")

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# f32: dgamma sums 8192 rows in another order than autograd's; bf16: the
# outputs' rounding (chip_smoke.py RMSNORM_BWD_TOL)
RMSNORM_BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
H100_SMS = 132
# (rows, d) of the port's paths and tests: the coded step (GC, M-SGC), serving
# (prefill, decode), the kernel tests' odd shapes
ROWS = (0, 1, 3, 8, 130, 3072, 4000, 8192)


def _widths():
    """Every d a norm of the port's configs takes (d_model; d_inner for the
    ssm gated norm), full and smoke, and the tests' widths."""
    ds = {100, 640, 8192}
    for arch in ARCHS:
        for cfg in (get_config(arch), get_smoke(arch)):
            ds.add(cfg.d_model)
            if cfg.family == "ssm":
                ds.add(cfg.ssm_d_inner)
    return sorted(ds)


def _vec(itemsize, wide):
    return 16 // itemsize if wide else 1


def _teams(plan):
    """Rows a block of the kernel has in flight: one a team of warps."""
    return rn.WARPS // plan.bucket if plan.bucket else 1


# -- the plan -------------------------------------------------------------------


@pytest.mark.parametrize("d", _widths())
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("sm_count", [H100_SMS, 114, 1])
def test_plan_covers_the_row_and_leaves_no_slab_empty(d, itemsize, sm_count):
    for wide in (True, False):
        vec = _vec(itemsize, wide)
        for rows in ROWS:
            plan = rn._plan(rows, d, vec, sm_count)
            if plan.bucket:
                assert wide and plan.bucket in rn.BUCKETS
                covered = 32 * plan.bucket * rn.PACKS * vec
                assert d <= covered
                # the fewest warps that do
                assert plan.bucket == 1 or d > covered // 2
            else:
                assert not wide or d > 32 * max(rn.BUCKETS) * rn.PACKS * vec
            assert 1 <= plan.slabs <= rn.BLOCKS_PER_SM * sm_count
            assert plan.slabs * plan.rows_per_slab >= rows
            assert rows == 0 or (plan.slabs - 1) * plan.rows_per_slab < rows  # none empty


def test_plan_of_the_coded_step():
    """The coded step's norms, (8192, 896) bf16 on an H100: one warp a row, 256
    slabs of 32 rows (M-SGC's 3072 rows: 256 of 12)."""
    assert rn._plan(8192, 896, 8, H100_SMS) == rn.Plan(256, 32, 1)
    assert rn._plan(3072, 896, 8, H100_SMS) == rn.Plan(256, 12, 1)
    # d 896 at f32: 224 packs, two warps a row; 8192 at f32 is chunked
    assert rn._plan(8192, 896, 4, H100_SMS).bucket == 2
    assert rn._plan(1, 8192, 4, H100_SMS).bucket == 0


def test_wide_views():
    x = torch.zeros(4, 900, dtype=torch.bfloat16)
    p = x.data_ptr()
    assert rn._wide(896, 2, p, p + 16 * 896)
    assert not rn._wide(100, 2, p)            # rows of 200 bytes
    assert rn._wide(100, 4, p)                # rows of 400 bytes
    assert not rn._wide(896, 2, p, p + 2)     # a start one element off 16 bytes


# -- the kernel's reduction order, emulated ---------------------------------------


def _emulate(x, g, dy, plan, eps=1e-6):
    """(dx, dgamma) summed in the kernel's order, in f32 (dgamma in gamma's
    dtype): each thread adds its columns' dy * x * r over its team's rows of
    the slab (team k takes rows k, k + teams, ... of it), and the teams' sums
    are added in team order into the slab's partial row.  After the grid
    barrier lane k of a column adds slabs k, k + 32, ... in order; a warp holds
    lanes 4w..4w+3 and adds them by a butterfly, (0 + 1) + (2 + 3); the eight
    warps are added in order."""
    rows, d = x.shape
    xf, dyf, gf = x.float(), dy.float(), g.float()
    r = torch.rsqrt((xf * xf).sum(-1, keepdim=True) / d + eps)
    sgd = (xf * gf * dyf).sum(-1, keepdim=True)
    dx = r * gf * dyf - xf * (r * r * r * sgd / d)
    term = torch.zeros(plan.slabs * plan.rows_per_slab, d)
    term[:rows] = dyf * xf * r
    teams = _teams(plan)
    per = -(-plan.rows_per_slab // teams)
    t = term.view(plan.slabs, plan.rows_per_slab, d)
    t = torch.cat([t, torch.zeros(plan.slabs, per * teams - plan.rows_per_slab, d)], 1)
    t = t.view(plan.slabs, per, teams, d)  # [slab, i, k]: team k's i-th row
    acc = torch.zeros(plan.slabs, teams, d)
    for i in range(per):
        acc = acc + t[:, i]
    part = acc[:, 0]
    for k in range(1, teams):
        part = part + acc[:, k]
    lanes = -(-plan.slabs // 32)
    part = torch.cat([part, torch.zeros(lanes * 32 - plan.slabs, d)]).view(lanes, 32, d)
    lane = torch.zeros(32, d)
    for i in range(lanes):
        lane = lane + part[i]
    warp = (lane[0::4] + lane[1::4]) + (lane[2::4] + lane[3::4])
    dgamma = warp[0]
    for w in range(1, 8):
        dgamma = dgamma + warp[w]
    return dx.to(x.dtype), dgamma.to(g.dtype)


@pytest.mark.parametrize("rows,d", [(8192, 896), (3072, 896), (4000, 2048), (130, 640)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduction_order_matches_jax_and_autograd(rows, d, dtype):
    import jax
    import jax.numpy as jnp
    from repro.kernels.rmsnorm import ref as jax_ref

    rng = np.random.default_rng(rows + d)
    x, g, dy = (rng.standard_normal(s).astype(np.float32) for s in ((rows, d), (d,), (rows, d)))
    td = DTYPES[dtype]
    tx, tg, tdy = (torch.from_numpy(a).to(td) for a in (x, g, dy))
    plan = rn._plan(rows, d, _vec(tx.element_size(), True), H100_SMS)
    got = _emulate(tx, tg, tdy, plan)

    jd = getattr(jnp, dtype)
    _, pull = jax.vjp(lambda a, b: jax_ref.rmsnorm(a, b), jnp.asarray(x, jd), jnp.asarray(g, jd))
    want_jax = pull(jnp.asarray(dy, jd))
    xr, gr = tx.clone().requires_grad_(True), tg.clone().requires_grad_(True)
    want_torch = torch.autograd.grad(rn_ref.rmsnorm(xr, gr), (xr, gr), tdy)

    tol = RMSNORM_BWD_TOL[dtype]
    for a, b, c in zip(got, want_jax, want_torch):
        assert a.dtype == c.dtype and a.shape == c.shape
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), rtol=tol, atol=tol)
        torch.testing.assert_close(a.float(), c.float(), rtol=tol, atol=tol)


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(dev, rows, d, dtype, gamma_dtype, seed):
    rng = np.random.default_rng(seed)
    x, g, dy = (rng.standard_normal(s).astype(np.float32) for s in ((rows, d), (d,), (rows, d)))
    return (torch.from_numpy(x).to(dev, DTYPES[dtype]), torch.from_numpy(g).to(dev, DTYPES[gamma_dtype]),
            torch.from_numpy(dy).to(dev, DTYPES[dtype]))


def _check_against_plain(x, g, dy, got):
    xr, gr = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    want = torch.autograd.grad(rn_ref.rmsnorm(xr, gr), (xr, gr), dy)
    tol = RMSNORM_BWD_TOL["float32" if x.dtype == g.dtype == torch.float32 else "bfloat16"]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,dtype", [(8192, 896, "bfloat16"), (8192, 896, "float32"),
                                          (77, 8192, "float32"), (300, 100, "bfloat16")])
def test_dgamma_bit_identical_over_calls(cuda_device, rows, d, dtype):
    x, g, dy = _inputs(cuda_device, rows, d, dtype, dtype, 20)
    first = rn.rmsnorm_bwd(x, g, dy)
    for _ in range(10):
        dx, dg = rn.rmsnorm_bwd(x, g, dy)
        assert torch.equal(dg, first[1]) and torch.equal(dx, first[0])


@pytest.mark.cuda
def test_counters_across_changing_shapes(cuda_device):
    for i, (rows, d) in enumerate([(1, 8192), (8192, 896), (3, 100), (8192, 896), (1, 8192)]):
        for dtype in ("bfloat16", "float32"):
            x, g, dy = _inputs(cuda_device, rows, d, dtype, dtype, 30 + i)
            _check_against_plain(x, g, dy, rn.rmsnorm_bwd(x, g, dy))
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    torch.cuda.synchronize()
    assert rn._counter(cuda_device, stream).tolist() == [0, 0]


@pytest.mark.cuda
def test_one_launch_a_call(cuda_device):
    from torch.profiler import ProfilerActivity, profile

    x, g, dy = _inputs(cuda_device, 8192, 896, "bfloat16", "bfloat16", 40)
    rn.rmsnorm_bwd(x, g, dy)
    torch.cuda.synchronize()
    before = rn.rmsnorm_bwd.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            rn.rmsnorm_bwd(x, g, dy)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert rn.rmsnorm_bwd.launches == before + 5
    assert all("rmsnorm_bwd" in name for name in kernels) and len(kernels) <= 5, kernels


@pytest.mark.cuda
@pytest.mark.parametrize("d", [100, 640, 896, 2048, 4096, 8192])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gamma_dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain(cuda_device, d, dtype, gamma_dtype):
    for rows in (1, 257):
        x, g, dy = _inputs(cuda_device, rows, d, dtype, gamma_dtype, d + rows)
        before = rn.rmsnorm_bwd.launches
        got = torch.autograd.grad(rn_ops.rmsnorm(x.requires_grad_(True), g.requires_grad_(True)),
                                  (x, g), dy)
        assert rn.rmsnorm_bwd.launches == before + 1
        _check_against_plain(x.detach(), g.detach(), dy, got)
