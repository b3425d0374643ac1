"""The port's configs (``repro_torch.configs``), input shapes and ``_remat``
against the JAX package, on the CPU.

* The registry's configs equal the JAX package's, full and SMOKE, for every
  ported architecture; ``SHAPES`` and ``skip_reason`` equal.
* ``input_specs`` at full width gives meta tensors (no storage) of the shapes
  and dtypes of the JAX package's ``ShapeDtypeStruct``s.
* The dense configs' SMOKE forward logits, from the JAX package's parameters
  through ``params_from_jax``, match the reference: llama3.2-1b (tied head,
  rope theta 5e5), qwen2-72b (qkv bias), deepseek-67b.
* ``_remat``: policies "full", "dots" and "none" give the same loss and
  gradients, match ``jax.grad`` of the JAX ``loss_fn``, and differ in what they
  run again in the backward.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch.configs as tcfgs
import repro_torch.models as tm
from repro_torch.convert import params_from_jax
from repro_torch.train.coded import value_and_grad
from repro_torch.tree import tree_leaves

PORTED = ["llama3.2-1b", "mixtral-8x22b", "qwen2-moe-a2.7b", "qwen2-72b", "paligemma-3b",
          "qwen2-0.5b", "hubert-xlarge", "zamba2-2.7b", "mamba2-1.3b", "deepseek-67b"]
# f32 on the CPU: the two packages differ only in the order of their sums
TOL = dict(rtol=1e-4, atol=1e-4)
# tests/test_torch_kernels.py: f32 gradients, sums taken in other orders
GRAD_TOL = 1e-4


@pytest.fixture(scope="module")
def ref():
    """(jax, jax.numpy, repro.configs, repro.models)."""
    import jax
    import jax.numpy as jnp

    import repro.configs
    import repro.models

    return jax, jnp, repro.configs, repro.models


def test_registry_lists_the_ported_architectures(ref):
    jcfgs = ref[2]
    assert tcfgs.ARCHS == [a for a in jcfgs.ARCHS if a in PORTED]
    assert set(PORTED) <= set(jcfgs.ARCHS)


@pytest.mark.parametrize("arch", PORTED)
def test_configs_equal_the_reference(ref, arch):
    jcfgs = ref[2]
    for get in ("get_config", "get_smoke"):
        j, t = getattr(jcfgs, get)(arch), getattr(tcfgs, get)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.param_count(), t.head_dim_) == (j.param_count(), j.head_dim_)


def test_shapes_equal_the_reference(ref):
    jcfgs = ref[2]
    assert {k: dataclasses.asdict(v) for k, v in tcfgs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcfgs.SHAPES.items()}


@pytest.mark.parametrize("arch", PORTED)
def test_skip_reason_equals_the_reference(ref, arch):
    jcfgs = ref[2]
    for name in jcfgs.SHAPES:
        for get in ("get_config", "get_smoke"):
            assert tcfgs.skip_reason(getattr(tcfgs, get)(arch), tcfgs.SHAPES[name]) == \
                jcfgs.skip_reason(getattr(jcfgs, get)(arch), jcfgs.SHAPES[name])


@pytest.mark.parametrize("arch", PORTED)
def test_input_specs_match_the_reference_on_meta(ref, arch):
    """Every shape's step inputs at full width: the same keys, shapes and
    dtypes as the JAX package's, on the meta device (the hybrid's 500k cache
    alone would be 48 GB)."""
    jax = ref[0]
    jcfgs = ref[2]
    for name in jcfgs.SHAPES:
        want = jcfgs.input_specs(jcfgs.get_config(arch), name)
        got = tcfgs.input_specs(tcfgs.get_config(arch), name)
        jleaves = jax.tree_util.tree_flatten_with_path(want)[0]
        tleaves = _flatten(got)
        assert [jax.tree_util.keystr(p) for p, _ in jleaves] == list(tleaves)
        for (_, j), t in zip(jleaves, tleaves.values()):
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(j.shape)
            assert str(t.dtype).removeprefix("torch.") == str(j.dtype)


def _flatten(tree, prefix=""):
    """{JAX keystr of the path: leaf} of a nested dict, keys sorted as JAX does."""
    out = {}
    for k in sorted(tree):
        path = f"{prefix}[{k!r}]"
        out.update(_flatten(tree[k], path) if isinstance(tree[k], dict) else {path: tree[k]})
    return out


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-72b", "deepseek-67b"])
def test_dense_smoke_forward_matches_reference(ref, arch):
    jax, jnp, jcfgs, jm = ref
    jcfg, tcfg = jcfgs.get_smoke(arch), tcfgs.get_smoke(arch)
    tree = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0)))
    if tcfg.qkv_bias:  # non-zero biases, so that the bias path is exercised
        rng = np.random.default_rng(7)
        for name in ("bq", "bk", "bv"):
            leaf = tree["layers"]["attn"][name]
            tree["layers"]["attn"][name] = (0.1 * rng.standard_normal(leaf.shape)).astype(
                np.float32)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    want, _ = jm.forward(jax.tree.map(jnp.asarray, tree), jcfg, {"tokens": jnp.asarray(toks)})
    tparams = params_from_jax(tree, tcfg, device="cpu")
    assert ("head" in tparams) == (not tcfg.tie_embeddings)
    got, _ = tm.forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


class _CountMatmuls(TorchDispatchMode):
    """Counts the matrix products that reach dispatch (a product kept by the
    "dots" policy is replayed above this mode and not counted again)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                           torch.ops.aten.addmm.default)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-2.7b"])
def test_remat_policies_agree_with_each_other_and_jax_grad(ref, arch):
    """Loss and gradients under remat "full", "dots" and "none" agree to 1e-6
    and with jax.grad of the JAX package's loss_fn (which remats its layer
    bodies, the hybrid's shared block too); "full" runs every product of the
    layers twice, "dots" none of them."""
    jax, jnp, jcfgs, jm = ref
    jcfg, tcfg = jcfgs.get_smoke(arch), tcfgs.get_smoke(arch)
    tree = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(3)))
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    jloss, jgrad = jax.value_and_grad(jm.loss_fn)(jax.tree.map(jnp.asarray, tree),
                                                  jcfg, jbatch)
    want = tree_leaves(params_from_jax(jax.tree.map(np.asarray, jgrad), tcfg, device="cpu"))
    params = params_from_jax(tree, tcfg, device="cpu")
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    runs = {}
    for policy in ("full", "dots", "none"):
        cfg = tcfg.replace(remat_policy=policy)
        with _CountMatmuls() as count:
            loss, grads = value_and_grad(lambda p, cfg=cfg: tm.loss_fn(p, cfg, batch), params)
        runs[policy] = (loss, tree_leaves(grads), count.n)
    loss, grads, _ = runs["none"]
    assert float(loss) == pytest.approx(float(jloss), abs=GRAD_TOL)
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL)
    for policy in ("full", "dots"):
        assert float(runs[policy][0]) == pytest.approx(float(loss), abs=1e-6)
        for a, b in zip(runs[policy][1], grads):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert runs["dots"][2] == runs["none"][2] < runs["full"][2]
