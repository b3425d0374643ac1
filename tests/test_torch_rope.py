"""RoPE in the port: the plain version, the op's dispatch and the CUDA kernel
(``repro_torch/kernels/rope``, ``csrc/rope.cu``).

On the CPU:
  * the plain version (``ref.apply_rope``) against the JAX package's
    ``repro.models.layers.apply_rope`` at every head dim the port serves (64,
    80, 128, 256), positions (s,) and (b, s), in f32 and bf16;
  * the op's dispatch: CPU and meta tensors take the plain version and count
    no launch, ``plain=True`` takes it anywhere, and the attention layer
    passes its ``plain`` on;
  * the backward's closed form (dx1 = g1 cos + g2 sin, dx2 = g2 cos - g1 sin)
    in float64 against autograd of the plain version, and rounded as the
    kernel rounds (each product and sum in f32, one cast) bit for bit;
  * which views take the kernel's 16-byte packs (``rope.wide_path``), and the
    DTensor path on meta tensors: batch and heads kept where sharded, positions
    (b, s) split with the batch, no collective.
On the card (``-m cuda``, skipped without one), cases of one test: the
kernel's forward and backward bit-equal to the plain version's at
hubert-xlarge's coded step's (128, 16, 500, 80), at decode shapes (b, h, 1,
dh) with per-row positions, at each served head dim with GQA, on strided and
misaligned views (the scalar path), at a head dim whose half takes no packs,
in f32; and the launches over one hubert-xlarge coded step: 96 forward (the
forward and the recompute) and 48 backward, 144.  The JAX package is imported
inside the test that uses it.
"""

import importlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.rope import ops as rope_ops
from repro_torch.kernels.rope import ref as rope_ref

# the wrapper module (the package's ``rope`` name is the public function)
rk = importlib.import_module("repro_torch.kernels.rope.rope")

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the head dims the port serves, with a config that runs each
SERVED = {64: "qwen2-0.5b", 80: "zamba2-2.7b", 128: "qwen2-moe-a2.7b", 256: "paligemma-3b"}


def _heads_view(base: torch.Tensor, h: int, dh: int) -> torch.Tensor:
    """(b, s, h * dh) -> the (b, h, s, dh) view the attention's projections give."""
    b, s, _ = base.shape
    return base.reshape(b, s, h, dh).transpose(1, 2)


def _inputs(rng, b, h, s, dh, dtype, per_row, device="cpu"):
    x = torch.from_numpy(rng.standard_normal((b, s, h * dh)).astype(np.float32))
    if per_row:
        positions = torch.from_numpy(rng.integers(0, 4096, (b, s)).astype(np.int64))
    else:
        positions = torch.arange(s)
    return x.to(device, dtype), positions.to(device)


# -- the plain version against the JAX package ----------------------------------


@pytest.mark.parametrize("dh", sorted(SERVED))
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_equals_the_reference(dh, per_row, dtype):
    import jax.numpy as jnp

    from repro.models import layers as jax_layers

    theta = get_config(SERVED[dh]).rope_theta
    rng = np.random.default_rng(dh + per_row)
    x, positions = _inputs(rng, 2, 3, 17, dh, torch.float32, per_row)
    x = _heads_view(x, 3, dh)
    jdtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    want = jax_layers.apply_rope(jnp.asarray(x.numpy()).astype(jdtype),
                                 jnp.asarray(positions.numpy()), theta)
    got = rope_ref.apply_rope(x.to(DTYPES[dtype]), positions, theta)
    assert got.dtype == DTYPES[dtype] and got.shape == x.shape
    # the same f32 arithmetic; cos and sin of the two libraries may differ in
    # the last place
    tol = {"float32": 2e-6, "bfloat16": 1e-2}[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


# -- the op's dispatch ------------------------------------------------------------


def test_cpu_and_meta_take_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(3)
    x, positions = _inputs(rng, 2, 4, 9, 80, torch.bfloat16, False)
    q, k = _heads_view(x, 4, 80), _heads_view(x[..., :160], 2, 80)
    before = (rk.rope.launches, rk.rope_bwd.launches)
    got = rope_ops.rope(q, k, positions, 1e4)
    assert torch.equal(got[0], rope_ref.apply_rope(q, positions, 1e4))
    assert torch.equal(got[1], rope_ref.apply_rope(k, positions, 1e4))
    qm, km = q.to("meta"), k.to("meta")
    mq, mk = rope_ops.rope(qm, km, positions.to("meta"), 1e4)
    assert mq.device.type == "meta" and mq.shape == q.shape and mk.shape == k.shape
    assert mq.dtype == torch.bfloat16
    assert (rk.rope.launches, rk.rope_bwd.launches) == before


def test_attention_layer_passes_plain_on(monkeypatch):
    """``attention_apply(plain=True)`` rotates through the plain version, never
    the op; by default it takes the op."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import layers

    cfg = get_smoke("qwen2-0.5b").replace(dtype="float32")
    p = layers.attention_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator().manual_seed(1))
    calls = []
    real = rope_ops.rope
    monkeypatch.setattr(rope_ops, "rope", lambda *a: calls.append(1) or real(*a))
    plain, _ = layers.attention_apply(p, x, cfg, plain=True)
    assert calls == []
    ops, _ = layers.attention_apply(p, x, cfg)
    assert calls == [1]
    assert torch.equal(plain, ops)


# -- the backward's closed form ----------------------------------------------------


def _closed_form(g, cos, sin):
    """dx of the rotation, as the kernel computes it: each product and sum
    rounded in g's dtype (the tensors' own), then the halves joined."""
    g1, g2 = g.chunk(2, dim=-1)
    return torch.cat([g1 * cos + g2 * sin, g2 * cos - g1 * sin], dim=-1)


@pytest.mark.parametrize("per_row", [False, True])
def test_backward_closed_form_float64(per_row):
    """In float64, from the plain version's own f32 tables: the closed form
    against autograd of the plain version (f32, so within f32 rounding)."""
    rng = np.random.default_rng(11 + per_row)
    x, positions = _inputs(rng, 2, 3, 13, 80, torch.float32, per_row)
    x = _heads_view(x, 3, 80).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal(tuple(x.shape)).astype(np.float32))
    (want,) = torch.autograd.grad(rope_ref.apply_rope(x, positions, 1e4), x, g)
    cos, sin = rope_ref.rope_table(positions, 80, 1e4)
    got = _closed_form(g.double(), cos[:, None].double(), sin[:, None].double())
    np.testing.assert_allclose(got.numpy(), want.double().numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_rounded_as_the_kernel_is_autograd_bit_for_bit(dtype):
    """Each product, sum and difference rounded in f32 and the result cast
    once, as ``csrc/rope.cu`` computes it: autograd of the plain version's
    passes gives the same bits (the kernel's forward is the plain version's
    own ops, fused)."""
    rng = np.random.default_rng(5)
    x, positions = _inputs(rng, 2, 4, 11, 64, DTYPES[dtype], True)
    x = _heads_view(x, 4, 64).detach().requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal(tuple(x.shape)).astype(np.float32)).to(x.dtype)
    (want,) = torch.autograd.grad(rope_ref.apply_rope(x, positions, 1e4), x, g)
    cos, sin = rope_ref.rope_table(positions, 64, 1e4)
    got = _closed_form(g.float(), cos[:, None], sin[:, None]).to(x.dtype)
    assert torch.equal(got, want)


# -- the kernel's layout ----------------------------------------------------------


@pytest.mark.parametrize("dh", sorted(SERVED))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_projection_views_take_the_wide_path(dh, dtype):
    """The (b, h, s, dh) views of the projections, their contiguous outputs and
    the tables take 16-byte packs at every served head dim; a view one value
    off its start, or a head dim whose half is no whole number of packs, does
    not."""
    x = torch.zeros(2, 5, 4 * dh, dtype=DTYPES[dtype])
    q = _heads_view(x, 4, dh)
    cos = torch.zeros(1, 5, dh // 2)
    out = torch.empty(q.shape, dtype=q.dtype)
    assert rk.wide_path([q], [out], cos, cos)
    off = torch.zeros(2 * 5 * 4 * dh + 1, dtype=DTYPES[dtype])[1:].reshape(2, 5, 4 * dh)
    assert not rk.wide_path([_heads_view(off, 4, dh)], [out], cos, cos)
    odd = torch.zeros(2, 5, 4 * 20, dtype=DTYPES[dtype])
    assert not rk.wide_path([_heads_view(odd, 4, 20)], [torch.empty(2, 4, 5, 20)],
                            torch.zeros(1, 5, 10), torch.zeros(1, 5, 10))


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 2, 3, 8)
    cos = torch.zeros(1, 3, 4)
    with pytest.raises(ValueError, match="CUDA"):
        rk.rope([q], cos, cos)
    with pytest.raises(ValueError, match="CUDA"):
        rk.rope_bwd([q], cos, cos, [q])


@pytest.mark.parametrize("per_row", [False, True])
def test_dtensors_rotate_on_their_shards(per_row):
    """Meta DTensors over (2, 2), batch on one axis and heads on the other: q
    and k keep their placements, positions (b, s) are split with the batch,
    and no collective runs."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.comm_census import RankCounter
    from repro_torch.launch.mesh import make_mesh, rank_only_group

    b, s, dh = 4, 6, 64
    positions = torch.zeros((b, s) if per_row else (s,), dtype=torch.int64, device="meta")
    with rank_only_group(4):
        mesh = make_mesh((2, 2))
        q = distribute_tensor(torch.empty(b, 4, s, dh, device="meta"), mesh, [Shard(0), Shard(1)])
        k = distribute_tensor(torch.empty(b, 2, s, dh, device="meta"), mesh, [Shard(0), Shard(1)])
        k1 = distribute_tensor(torch.empty(b, 1, s, dh, device="meta"), mesh,
                               [Shard(0), Replicate()])
        with RankCounter() as counter:
            got = rope_ops.rope(q, k, positions, 1e4)
            assert [t.placements for t in got] == [(Shard(0), Shard(1))] * 2
            assert [t.shape for t in got] == [q.shape, k.shape]
            _, got1 = rope_ops.rope(q, k1, positions, 1e4)
            assert got1.placements == (Shard(0), Replicate()) and got1.shape == k1.shape
        assert counter.collectives == []


# -- on the card ---------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _bits(dev, b, hq, hk, s, dh, dtype=torch.bfloat16, per_row=False, theta=1e4,
          offset=0, fused=False, seed=0):
    """The kernel against the plain version, forward and backward, on the
    projections' head-transposed views (``fused``: q and k slices of one
    projection's output; ``offset``: every view that many values off a
    16-byte start), and the launches each way: one."""
    rng = np.random.default_rng(seed)
    x, positions = _inputs(rng, b, hq + hk, s, dh, dtype, per_row, dev)
    if offset:
        buf = torch.empty(x.numel() + offset, dtype=dtype, device=dev)
        x = buf[offset:].view(x.shape).copy_(x)
    if not fused:
        x = x.contiguous()
    gq = torch.from_numpy(rng.standard_normal((b, hq, s, dh)).astype(np.float32)).to(dev, dtype)
    gk = torch.from_numpy(rng.standard_normal((b, hk, s, dh)).astype(np.float32)).to(dev, dtype)
    outs, grads = [], []
    for rotate in ("kernel", "plain"):
        base = x.detach().requires_grad_(True)
        if fused:
            q = _heads_view(base[..., :hq * dh], hq, dh)
            k = _heads_view(base[..., hq * dh:], hk, dh)
        else:
            q = _heads_view(base[..., :hq * dh].contiguous(), hq, dh)
            k = _heads_view(base[..., hq * dh:].contiguous(), hk, dh)
        launches = (rk.rope.launches, rk.rope_bwd.launches)
        if rotate == "kernel":
            outs_like = [torch.empty(t.shape, dtype=dtype, device=dev) for t in (q, k)]
            wide = rk.wide_path([q, k], outs_like, *rope_ref.rope_table(positions, dh, theta, dev))
            got = rope_ops.rope(q, k, positions, theta)
            assert got[0].is_contiguous() and got[1].is_contiguous()
        else:
            got = tuple(rope_ref.apply_rope(t, positions, theta) for t in (q, k))
        (dx,) = torch.autograd.grad(got, base, (gq, gk))
        torch.cuda.synchronize()
        ran = (rk.rope.launches - launches[0], rk.rope_bwd.launches - launches[1])
        assert ran == ((1, 1) if rotate == "kernel" else (0, 0))
        outs.append(got)
        grads.append(dx)
    for a, w in zip(outs[0], outs[1]):
        assert a.dtype == w.dtype and torch.equal(a, w)
    assert torch.equal(grads[0], grads[1])
    return wide


def _hubert_train(dev):
    cfg = get_config("hubert-xlarge")
    assert _bits(dev, 128, 16, 16, 500, 80, theta=cfg.rope_theta)


def _decode(dev):
    for dh, arch in SERVED.items():
        cfg = get_config(arch)
        assert _bits(dev, 8, cfg.num_heads, cfg.num_kv_heads, 1, dh, per_row=True,
                     theta=cfg.rope_theta, seed=dh)


def _served(dev):
    """Each served head dim at its config's heads (GQA) over 500 positions,
    and with per-row positions."""
    for dh, arch in SERVED.items():
        cfg = get_config(arch)
        for per_row in (False, True):
            assert _bits(dev, 4, cfg.num_heads, cfg.num_kv_heads, 500, dh, per_row=per_row,
                         theta=cfg.rope_theta, seed=dh)


def _strided(dev):
    """q and k as slices of one fused projection: strided rows, read in place."""
    assert _bits(dev, 4, 16, 4, 300, 80, fused=True)
    assert _bits(dev, 4, 8, 2, 64, 256, fused=True, per_row=True)


def _scalar(dev):
    """Views one value off a 16-byte start, and dh 20 (a half of 10 values):
    the kernel's one-pair-a-thread path, the same bits."""
    assert not _bits(dev, 4, 16, 4, 300, 80, fused=True, offset=1)
    assert not _bits(dev, 2, 4, 4, 33, 20)
    assert not _bits(dev, 2, 4, 4, 33, 20, dtype=torch.float32, per_row=True)


def _float32(dev):
    for dh in sorted(SERVED):
        assert _bits(dev, 2, 8, 2, 129, dh, dtype=torch.float32, per_row=dh == 80)


def _hubert_step_launches(dev):
    """One coded step of full hubert-xlarge (48 layers, "full" remat): each
    layer's RoPE forward in the forward and again in the recompute, its
    backward once."""
    from repro_torch.core import make_gradient_code
    from repro_torch.data import gc_chunked_batch
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.train import gc_round_weights, init_train_state, make_coded_train_step

    cfg = get_config("hubert-xlarge")
    n, s_, chunk, frames = 4, 1, 1, 500
    params, opt = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    b = n * chunk
    batch = {"frames": torch.randn(b, frames, cfg.d_model, generator=gen, device=dev),
             "labels": torch.randint(0, cfg.vocab_size, (b, frames), generator=gen, device=dev,
                                     dtype=torch.int32)}
    coded = gc_chunked_batch(batch, n, s_)
    w = gc_round_weights(make_gradient_code(n, s_, prefer_rep=False), [0, 1, 3])
    step = make_coded_train_step(cfg, n, s_)
    before = (rk.rope.launches, rk.rope_bwd.launches, flash_attention.launches)
    params, opt, m = step(params, opt, coded, w)
    torch.cuda.synchronize()
    ran = [a - z for a, z in zip((rk.rope.launches, rk.rope_bwd.launches,
                                  flash_attention.launches), before)]
    assert np.isfinite(float(m["loss"]))
    assert ran == [2 * cfg.num_layers, cfg.num_layers, 2 * cfg.num_layers] == [96, 48, 96]
    assert ran[0] + ran[1] == 144


CARD_CASES = {"hubert-train": _hubert_train, "decode": _decode, "served": _served,
              "strided": _strided, "scalar": _scalar, "float32": _float32,
              "hubert-step-launches": _hubert_step_launches}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernel_on_the_card(cuda_device, case):
    CARD_CASES[case](cuda_device)
