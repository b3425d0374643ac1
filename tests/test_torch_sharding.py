"""The port's sharding rules (``repro_torch.launch.sharding``) and production
meshes against the JAX package's, on the CPU, and the collective census.

The JAX package's rules run on a stand-in mesh that has only ``shape`` (a
dict) and ``axis_names``, so no 256 JAX devices are needed; where a reference
function wraps its spec in a ``NamedSharding``, the test swaps that class for
one that returns the spec.  The port's rules run on real DeviceMeshes of 256
and 512 ranks over the rank-only group (``rank_only_group``).  Exact:

* every parameter leaf of all ten architectures, on 16x16 and 2x16x16, the
  same choice per dimension (the JAX package's stacked ``layers`` leaf, its
  leading scan axis dropped, against each of the port's per-layer leaves);
* ``batch_shardings`` in both profiles over ``input_specs`` of every runnable
  pair, ``cache_shardings`` in both modes (b = 1 at ``long_500k`` included),
  ``opt_shardings``;
* the divisibility fallback of ``tests/test_shapes_and_sharding.py``;
* ``make_production_mesh``'s shapes and axes, and its refusal with too few ranks.

The census (``comm_census``) on a (1, 4) meta mesh: a column- then
row-parallel MLP makes one all-reduce of b*s*d*itemsize bytes; with its
weights gathered instead, all-gathers of the weight shards' bytes.
"""

import pytest
import torch
import torch.distributed as dist

import repro_torch.configs as tcfgs
import repro_torch.models as tm
from repro_torch.dtensor import placements
from repro_torch.launch import sharding as tsh
from repro_torch.launch.mesh import (
    make_mesh,
    make_production_mesh,
    rank_only_group,
)
from repro_torch.optim import adamw_init

ARCHS = tcfgs.ARCHS


class StandInMesh:
    """What the JAX package's rules read of a mesh."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = names


@pytest.fixture(scope="module")
def ref():
    import jax

    import repro.configs
    import repro.launch.sharding as rsh
    import repro.models
    import repro.optim

    return jax, repro.configs, repro.models, repro.optim, rsh


@pytest.fixture
def meshes():
    """{"16x16": (port mesh, stand-in), "2x16x16": ...} over one rank-only
    group of 512 ranks, closed when the test ends."""
    with rank_only_group(512):
        yield {
            "16x16": (make_production_mesh(), StandInMesh((16, 16), ("data", "model"))),
            "2x16x16": (make_production_mesh(multi_pod=True),
                        StandInMesh((2, 16, 16), ("pod", "data", "model"))),
        }


def _norm(spec, ndim):
    """A JAX PartitionSpec as a tuple of ndim entries, each None, a name or a
    tuple of names."""
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        if isinstance(e, (tuple, list)) and len(e) == 1:
            e = e[0]
        out.append(tuple(e) if isinstance(e, (tuple, list)) else e)
    return tuple(out)


def _leaves_with_keys(tree, path=()):
    """(keys, leaf) of the port's tree, list indices included as ints."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_keys(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves_with_keys(v, path + (i,))
    else:
        yield path, tree


def _ref_specs(ref, tree_shape, fn):
    """{key path (str keys, a stacked leaf's first key 'layers'): fn(keys,
    leaf)} over the JAX package's ShapeDtypeStruct tree."""
    jax = ref[0]
    out = {}

    def one(path, leaf):
        keys = tuple(str(getattr(p, "key", getattr(p, "name", getattr(p, "idx", p))))
                     for p in path)
        out[keys] = fn(keys, leaf)

    jax.tree_util.tree_map_with_path(one, tree_shape)
    return out


@pytest.fixture
def named_spec(ref, monkeypatch):
    """The reference's NamedSharding, swapped for its spec."""
    monkeypatch.setattr(ref[4], "NamedSharding", lambda mesh, spec: spec)


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_rules_equal_the_reference(ref, meshes, arch, mesh_name):
    jax, rcfgs, rmodels, _, rsh = ref
    mesh, stand_in = meshes[mesh_name]
    rcfg = rcfgs.get_config(arch)
    shapes = jax.eval_shape(lambda: rmodels.init_params(rcfg, jax.random.PRNGKey(0)))
    want = _ref_specs(ref, shapes, lambda k, leaf: rsh._moe_fix(
        k, leaf, rcfg, stand_in, rsh.param_pspec(k, leaf, rcfg, stand_in)))
    cfg = tcfgs.get_config(arch)
    params = tm.init_params(cfg, None)
    got_place = dict(_leaves_with_keys(tsh.params_shardings(cfg, params, mesh)))
    n = 0
    for keys, leaf in _leaves_with_keys(params):
        rkeys = tuple(k for k in keys if isinstance(k, str))
        stacked = keys[0] == "layers"
        spec = want[rkeys]
        ndim = leaf.dim() + stacked
        spec = _norm(spec, ndim)[1:] if stacked else _norm(spec, ndim)
        if stacked:
            assert _norm(want[rkeys], ndim)[0] is None, rkeys   # the scan axis stays whole
        got = tsh._moe_fix(rkeys, leaf, cfg, mesh, tsh.param_pspec(rkeys, leaf, cfg, mesh))
        assert _norm(got, leaf.dim()) == spec, (keys, got, spec)
        assert got_place[keys] == placements(mesh, spec), keys
        n += 1
    assert n == sum(1 for _ in _leaves_with_keys(params))


def _runnable(arch):
    cfg = tcfgs.get_config(arch)
    return [s for s, shape in tcfgs.SHAPES.items() if not tcfgs.skip_reason(cfg, shape)]


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_rules_equal_the_reference(ref, meshes, named_spec, arch, mesh_name):
    jax, rcfgs, _, _, rsh = ref
    mesh, stand_in = meshes[mesh_name]
    rcfg, cfg = rcfgs.get_config(arch), tcfgs.get_config(arch)
    checked = 0
    for shape in _runnable(arch):
        rspecs, specs = rcfgs.input_specs(rcfg, shape), tcfgs.input_specs(cfg, shape)
        if "batch" in specs:
            for profile in ("tp", "fsdp"):
                want = rsh.batch_shardings(rcfg, rspecs["batch"], stand_in, profile=profile)
                got = tsh.batch_shardings(cfg, specs["batch"], mesh, profile=profile)
                for k, leaf in specs["batch"].items():
                    assert got[k] == placements(mesh, _norm(want[k], leaf.dim())), \
                        (shape, profile, k)
                    checked += 1
            continue
        for mode in ("auto", "headdim"):
            want = rsh.cache_shardings(rcfg, rspecs["cache"], stand_in, mode=mode)
            got = tsh.cache_shardings(cfg, specs["cache"], mesh, mode=mode)
            assert set(got) == set(want)
            for k, leaf in specs["cache"].items():
                assert got[k] == placements(mesh, _norm(want[k], leaf.dim())), (shape, mode, k)
                checked += 1
        want = rsh.batch_shardings(rcfg, {"t": rspecs["token"]}, stand_in)["t"]
        got = tsh.batch_shardings(cfg, {"t": specs["token"]}, mesh)["t"]
        assert got == placements(mesh, _norm(want, 2))
    assert checked


def test_long_context_cache_spreads_its_sequence(meshes):
    """b = 1 at long_500k: the sequence over every axis (the reference's
    branch for a batch that does not divide the data axes)."""
    mesh, _ = meshes["2x16x16"]
    cfg = tcfgs.get_config("zamba2-2.7b")
    cache = tcfgs.input_specs(cfg, "long_500k")["cache"]
    got = tsh.cache_shardings(cfg, cache, mesh)
    assert got["shared_k"] == placements(mesh, (None, None, None, ("pod", "data", "model"), None))
    assert got["state"] == placements(mesh, (None, None, "model", None, None))


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-1.3b"])
def test_opt_rules_mirror_the_params(meshes, arch):
    mesh, _ = meshes["16x16"]
    cfg = tcfgs.get_config(arch)
    params = tm.init_params(cfg, None)
    p_shard = tsh.params_shardings(cfg, params, mesh)
    opt = adamw_init(params)
    o_shard = tsh.opt_shardings(cfg, opt, mesh, p_shard)
    assert o_shard.m == p_shard and o_shard.v == p_shard and o_shard.step is None
    assert tsh.replicated(mesh) == placements(mesh, (None, None))


def test_divisibility_fallback(meshes):
    """tests/test_shapes_and_sharding.py:96: a dimension that does not divide
    the axis is replicated; one that does keeps it."""
    mesh, _ = meshes["16x16"]

    class Leaf:
        def __init__(self, shape):
            self.shape = shape

    assert tsh.param_pspec(("layers", "attn", "wq"), Leaf((64, 100)), None, mesh) == (None, None)
    assert tsh.param_pspec(("layers", "attn", "wq"), Leaf((64, 128)), None, mesh) == \
        (None, "model")
    assert tsh.param_pspec(("layers", "attn", "wo"), Leaf((100, 64)), None, mesh) == (None, None)
    assert tsh.param_pspec(("embed",), Leaf((1000, 64)), None, mesh) == (None, None)
    assert tsh.param_pspec(("layers", "norm1", "gamma"), Leaf((64,)), None, mesh) == (None,)


def test_production_meshes(meshes):
    single, _ = meshes["16x16"]
    multi, _ = meshes["2x16x16"]
    assert tuple(single.shape) == (16, 16) and single.mesh_dim_names == ("data", "model")
    assert tuple(multi.shape) == (2, 16, 16)
    assert multi.mesh_dim_names == ("pod", "data", "model")
    assert list(single.get_coordinate()) == [0, 0]
    assert list(multi.get_coordinate()) == [0, 0, 0]


def test_production_mesh_refuses_too_few_ranks():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs 256 ranks, have 0"):
        make_production_mesh()
    with rank_only_group(256) as opened:
        assert opened and dist.get_world_size() == 256
        with pytest.raises(RuntimeError, match="needs 512 ranks, have 256"):
            make_production_mesh(multi_pod=True)
        with rank_only_group(512) as again:       # the caller's group is left alone
            assert not again and dist.get_world_size() == 256
        assert dist.is_initialized()
    assert not dist.is_initialized()


def test_placements_refuse_axes_out_of_mesh_order():
    with rank_only_group(4):
        mesh = make_mesh((2, 2))
        with pytest.raises(ValueError, match="not in the mesh's order"):
            placements(mesh, (("model", "data"),))


def test_kernel_ops_run_on_local_shards_where_the_placements_allow():
    """The kernel ops on meta DTensors over (2, 2): RMSNorm keeps sharded rows
    and gathers a sharded last dimension; attention keeps the batch and the
    heads where the kv heads split alike, and gathers the heads where they do
    not; the fused chunk scan keeps the batch.  Each gather is a collective
    the census sees."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.comm_census import RankCounter

    def meta(shape, *places):
        return distribute_tensor(torch.empty(shape, device="meta"), mesh, list(places))

    R, S0, S1 = Replicate(), Shard(0), Shard(1)
    with rank_only_group(4):
        mesh = make_mesh((2, 2))
        with RankCounter() as counter:
            y = rn_ops.rmsnorm(meta((8, 16, 32), S0, Shard(2)), meta((32,), R, R))
        assert y.placements == (S0, R) and y.shape == (8, 16, 32)
        assert [k for k, _, _ in counter.collectives] == ["all-gather"]
        q, kv = meta((8, 4, 16, 32), S0, S1), meta((8, 2, 16, 32), S0, S1)
        assert fa_ops.attention(q, kv, kv).placements == (S0, S1)
        kv1 = meta((8, 1, 16, 32), S0, R)
        assert fa_ops.attention(q, kv1, kv1).placements == (S0, R)
        b, nc, Q, nh, hd, st = 4, 2, 8, 2, 4, 3
        args = [meta(shape, S0, R) for shape in ((b, nc, Q, nh, hd), (b, nc, Q, nh),
                                                 (b, nc, Q, nh), (b, nc, Q, st), (b, nc, Q, st),
                                                 (b, nc, nh, hd, st))]
        y = ssd_ops.ssd_chunk_scan(*args, meta((nh,), R, R), nc * Q)
        assert y.placements == (S0, R) and y.shape == (b, nc * Q, nh, hd)


def test_census_of_column_then_row_parallel_products():
    """On a (1, 4) meta mesh: x @ w1 (column-parallel) @ w2 (row-parallel) made
    whole is exactly one all-reduce of b * s * d * itemsize bytes; with the
    batch sharded and the weights gathered instead, two all-gathers, each of
    its weight's bytes whole (the shards' bytes together), and no other
    collective."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.comm_census import RankCounter

    b, s, d, f = 4, 16, 32, 64
    R = Replicate()
    with rank_only_group(4):
        mesh = make_mesh((1, 4))

        def meta(shape, *places):
            return distribute_tensor(torch.empty(shape, dtype=torch.bfloat16, device="meta"),
                                     mesh, list(places))

        x, w1, w2 = meta((b, s, d), R, R), meta((d, f), R, Shard(1)), meta((f, d), R, Shard(0))
        with RankCounter() as counter:
            y = ((x @ w1) @ w2).redistribute(mesh, [R, R])
        assert y.shape == (b, s, d)
        assert counter.census() == {"all-reduce": {"count": 1, "bytes": b * s * d * 2},
                                    "total_bytes": b * s * d * 2,
                                    "raw_body_once_bytes": b * s * d * 2}
        xb = meta((b, s, d), R, Shard(0))
        with RankCounter() as counter:
            y = (xb @ w1.redistribute(mesh, [R, R])) @ w2.redistribute(mesh, [R, R])
        assert y.placements == (R, Shard(0))
        assert [(k, n) for k, n, _ in counter.collectives] == [("all-gather", d * f * 2)] * 2
