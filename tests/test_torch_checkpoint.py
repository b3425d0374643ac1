"""The port's checkpoints (``repro_torch.checkpoint.io``) against the JAX
package's: a blob, a tree with bf16 leaves and a train state written by
either package load in the other with equal values and dtypes, and a
corrupt blob raises ``ValueError`` in both."""

from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import io as tio
from repro_torch.optim import AdamWState


@pytest.fixture(scope="module")
def ref():
    import jax.numpy as jnp

    from repro.checkpoint import io as rio
    from repro.optim.adamw import AdamWState as RefState

    return rio, jnp, RefState


def _blob():
    return {
        "version": 1,
        "arrays": [np.arange(6).reshape(2, 3), np.zeros(0), np.ones((2, 2), np.float32)],
        "nested": {"flag": True, "none": None, "name": "run",
                   "mask": np.array([True, False])},
        "scalars": [1, 2.5, np.float64(3.5), np.int64(7), np.bool_(True)],
        "tuple": (1, "a"),
    }


def _assert_blob_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_blob_equal(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_blob_equal(a, b)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_blob_reads_both_ways(ref, tmp_path, writer):
    rio = ref[0]
    save = tio.save_blob if writer == "port" else rio.save_blob
    path = save(str(tmp_path / "state"), _blob())
    assert path.endswith(".npz")
    _assert_blob_equal(tio.load_blob(path), rio.load_blob(path))
    back = tio.load_blob(path)
    assert back["tuple"] == [1, "a"] and back["scalars"] == [1, 2.5, 3.5, 7, True]


def test_blob_bytes_equal_the_reference(ref, tmp_path):
    """Same skeleton, same members: the archives' members are byte for
    byte the same (the zip headers carry timestamps)."""
    import zipfile

    rio = ref[0]
    p = tio.save_blob(str(tmp_path / "port"), _blob())
    r = rio.save_blob(str(tmp_path / "ref"), _blob())
    with zipfile.ZipFile(p) as zp, zipfile.ZipFile(r) as zr:
        assert zp.namelist() == zr.namelist()
        for name in zr.namelist():
            assert zp.read(name) == zr.read(name)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_corrupt_blob_raises_valueerror_in_both(ref, tmp_path, writer):
    rio = ref[0]
    save = tio.save_blob if writer == "port" else rio.save_blob
    path = save(str(tmp_path / "b"), {"a": np.arange(4096)})
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[: len(raw) // 2])
    for load in (tio.load_blob, rio.load_blob):
        with pytest.raises(ValueError, match="blob"):
            load(path)
    garbage = tmp_path / "garbage.npz"
    garbage.write_bytes(b"this is not a zip archive at all")
    for load in (tio.load_blob, rio.load_blob):
        with pytest.raises(ValueError, match="garbage.npz"):
            load(str(garbage))
    with pytest.raises(FileNotFoundError):
        tio.load_blob(str(tmp_path / "never_saved.npz"))
    with pytest.raises(TypeError, match="str"):
        tio.save_blob(str(tmp_path / "bad"), {1: np.ones(2)})


class _Pair(NamedTuple):
    a: object
    b: object


def _tree(gen):
    """Dicts (keys out of order), a list and a NamedTuple, f32, bf16 and int32
    leaves (the JAX package holds no int64 without x64)."""
    return {
        "z": torch.randn(3, 4, generator=gen),
        "emb": torch.randn(5, 2, generator=gen).to(torch.bfloat16),
        "layers": [{"w": torch.randn(2, 2, generator=gen), "b": torch.arange(3, dtype=torch.int32)}
                   for _ in range(2)],
        "pair": _Pair(torch.randn(4, generator=gen).to(torch.bfloat16),
                      torch.tensor(7, dtype=torch.int32)),
    }


def _to_jax(tree, jnp):
    if isinstance(tree, dict):
        return {k: _to_jax(v, jnp) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_jax(v, jnp) for v in tree))
    if isinstance(tree, list):
        return [_to_jax(v, jnp) for v in tree]
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.float().numpy(), dtype=jnp.bfloat16)
    return jnp.asarray(tree.numpy())


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_pytree_with_bf16_leaves_reads_both_ways(ref, tmp_path, writer):
    rio, jnp, _ = ref
    tree = _tree(torch.Generator().manual_seed(0))
    jtree = _to_jax(tree, jnp)
    path = str(tmp_path / "tree.npz")
    (tio.save_pytree(path, tree) if writer == "port" else rio.save_pytree(path, jtree))
    got = tio.load_pytree(path, tree)
    for (key, g), (_, w) in zip(tio._flatten_with_paths(got), tio._flatten_with_paths(tree)):
        assert g.dtype == w.dtype, key
        assert torch.equal(g, w), key
    assert isinstance(got["pair"], _Pair) and isinstance(got["layers"], list)
    want = rio.load_pytree(path, jtree)
    for (key, g), (_, w) in zip(tio._flatten_with_paths(want), tio._flatten_with_paths(tree)):
        assert str(g.dtype) == str(w.dtype).split(".")[1], key
        np.testing.assert_array_equal(np.asarray(g, dtype=np.float64),
                                      w.double().numpy(), err_msg=key)


def test_pytree_shape_mismatch_raises(tmp_path):
    tree = _tree(torch.Generator().manual_seed(1))
    path = str(tmp_path / "tree.npz")
    tio.save_pytree(path, tree)
    tree["z"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="shape mismatch for z"):
        tio.load_pytree(path, tree)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_train_state_reads_both_ways(ref, tmp_path, writer):
    rio, jnp, RefState = ref
    gen = torch.Generator().manual_seed(2)
    params = {"w": torch.randn(3, 2, generator=gen).to(torch.bfloat16),
              "b": torch.randn(2, generator=gen)}
    m = {k: torch.randn(v.shape, generator=gen) for k, v in params.items()}
    v = {k: torch.rand(v.shape, generator=gen) for k, v in params.items()}
    opt = AdamWState(step=5, m=m, v=v)
    jparams, jm, jv = (_to_jax(t, jnp) for t in (params, m, v))
    jopt = RefState(step=jnp.asarray(5, jnp.int32), m=jm, v=jv)
    path = str(tmp_path / "state.npz")
    if writer == "port":
        tio.save_train_state(path, params, opt, step=12)
    else:
        rio.save_train_state(path, jparams, jopt, step=12)

    zeros = {k: torch.zeros_like(t) for k, t in params.items()}
    like = AdamWState(step=0, m={k: torch.zeros_like(t) for k, t in m.items()},
                      v={k: torch.zeros_like(t) for k, t in v.items()})
    p2, o2, step = tio.restore_train_state(path, zeros, like)
    assert step == 12 and isinstance(o2, AdamWState) and o2.step == 5
    for k in params:
        assert p2[k].dtype == params[k].dtype and torch.equal(p2[k], params[k])
        assert torch.equal(o2.m[k], m[k]) and torch.equal(o2.v[k], v[k])

    jzeros = {k: jnp.zeros_like(t) for k, t in jparams.items()}
    jlike = RefState(step=jnp.zeros((), jnp.int32), m={k: jnp.zeros_like(t) for k, t in jm.items()},
                     v={k: jnp.zeros_like(t) for k, t in jv.items()})
    rp, ro, rstep = rio.restore_train_state(path, jzeros, jlike)
    assert rstep == 12 and int(ro["step"]) == 5 and str(ro["step"].dtype) == "int32"
    for k in params:
        assert str(rp[k].dtype) == str(params[k].dtype).split(".")[1]
        np.testing.assert_array_equal(np.asarray(rp[k], np.float32), params[k].float().numpy())
        np.testing.assert_array_equal(np.asarray(ro["m"][k]), m[k].numpy())
