"""The port's dry-run (``repro_torch.launch.dryrun``), the §Perf table
(``launch.perf``) and sharded steps on DTensors, on the CPU.

* ``run_pair`` on the SMOKE config of every family (dense, moe, ssm, hybrid,
  vlm, audio) on (2, 2) and (2, 2, 2) rank-only meshes, train, prefill and
  decode, plain and GC / M-SGC coded: status ok, the JAX package's record keys.
* The skip matrix equals the JAX package's: 32 runnable pairs, 8 skips with
  its reasons.
* qwen2-0.5b ``train_4k`` at full width on 16x16: ``memory.argument_bytes``
  equals a sum computed from the JAX package's PartitionSpecs and shapes.
* On a (1, 1) mesh the count of a SMOKE train step on meta tensors equals the
  same counter over the step on real CPU tensors, and the analytic count.
* ``PAIRS`` has the JAX package's pairs and variants.
* ``fsdp-act``: the hidden states take the pinned placements; the census pins
  what DTensor then does.
* The world-1 gloo step on a (1, 1) CPU mesh is bit-identical to the plain
  step, and within ``CODED_GRAD_TOL`` of the JAX package's ``make_train_step``
  jitted with its own shardings on ``make_cpu_mesh(1, 1)``.
* Four gloo processes on a (2, 2) mesh: a SMOKE dense step and a moe step
  with capacity drops, their losses and gathered updated parameters within
  ``CODED_GRAD_TOL`` of the one-process step.  This is the one place where
  sharded numerics are computed.

The ``cuda`` test holds the sharded SMOKE step on the card, through the
kernels, to the plain one bit for bit.
"""

import ast
import copy
import math
import multiprocessing
import socket
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch.configs as tcfgs
from repro_torch.configs import InputShape
from repro_torch.convert import params_from_jax
from repro_torch.launch import perf
from repro_torch.launch import sharding as tsh
from repro_torch.launch.comm_census import RankCounter
from repro_torch.launch.dryrun import run_pair, trace_pair
from repro_torch.launch.mesh import local_group, make_local_mesh, make_mesh, rank_only_group
from repro_torch.models import init_params
from repro_torch.models.transformer import _act_constraint
from repro_torch.optim import adamw_init
from repro_torch.train.coded import make_train_step
from repro_torch.tree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
# chip_smoke.py / tests/test_torch_vlm_train.py: sums taken in other orders
CODED_GRAD_TOL = dict(rtol=2e-3, atol=1e-4)
FAMILIES = ["qwen2-0.5b", "qwen2-moe-a2.7b", "mamba2-1.3b", "zamba2-2.7b", "paligemma-3b",
            "hubert-xlarge"]
# the JAX package's record (src/repro/launch/dryrun.py:167-175, 213-235)
RECORD_KEYS = {"arch", "shape", "mesh", "coded", "tag", "status", "skip_reason", "lower_s",
               "compile_s", "num_devices", "flops_per_device_scanned",
               "bytes_per_device_scanned", "flops_per_device", "bytes_per_device", "unrolled",
               "memory", "collectives", "param_count", "active_param_count"}


@pytest.fixture(scope="module")
def ref():
    """(jax, repro.configs, repro.models, repro.launch.sharding, repro.launch.mesh,
    repro.train.coded, repro.optim)."""
    import jax

    import repro.configs
    import repro.launch.mesh
    import repro.launch.sharding
    import repro.models
    import repro.optim
    import repro.train.coded

    return (jax, repro.configs, repro.models, repro.launch.sharding, repro.launch.mesh,
            repro.train.coded, repro.optim)


def _check_record(rec, coded=False):
    assert rec["status"] == "ok", rec
    assert RECORD_KEYS <= set(rec)
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes"}
    assert rec["flops_per_device"] == rec["flops_per_device_scanned"] > 0
    assert rec["memory"]["argument_bytes"] > 0 and rec["memory"]["temp_bytes"] > 0
    census = rec["collectives"]
    assert census["total_bytes"] == census["raw_body_once_bytes"] == sum(
        v["bytes"] for k, v in census.items() if isinstance(v, dict))
    assert rec["coded"] == coded


# SMOKE-sized stand-ins for the four shapes (the full ones run the SSM's chunk
# loop 512 times at 32k, which the test does not need)
SMOKE_SHAPES = {"train": InputShape("train_smoke", 128, 8, "train"),
                "prefill": InputShape("prefill_smoke", 256, 4, "prefill"),
                "decode": InputShape("decode_smoke", 256, 8, "decode")}


# every family and mode on (2, 2); on (2, 2, 2) a moe train step (attention,
# experts) and the dense and ssm decode steps: DTensor's search for an op's sharding
# grows with the cube of its choices a mesh axis on three axes, some seconds
# for each new op signature, and every run_pair opens a new mesh
PAIR_RUNS = ([(arch, (2, 2), ("train", "prefill", "decode", "gc", "msgc")) for arch in FAMILIES]
             + [("qwen2-moe-a2.7b", (2, 2, 2), ("train",)),
                ("qwen2-0.5b", (2, 2, 2), ("decode",)),
                ("mamba2-1.3b", (2, 2, 2), ("decode",))])


@pytest.mark.parametrize("arch,mesh_shape,modes", PAIR_RUNS)
def test_run_pair_on_smoke_configs(arch, mesh_shape, modes):
    cfg = tcfgs.get_smoke(arch)
    for mode in modes:
        coded = mode if mode in ("gc", "msgc") else False
        shape = SMOKE_SHAPES["train" if coded else mode]
        if tcfgs.skip_reason(cfg, shape):
            assert mode == "decode" and not cfg.has_decode
            continue
        rec = run_pair(arch, shape, cfg=cfg, mesh_shape=mesh_shape, coded=coded, verbose=False)
        _check_record(rec, coded)
        assert rec["shape"] == shape.name and rec["mesh"] == "x".join(map(str, mesh_shape))
        assert rec["num_devices"] == math.prod(mesh_shape)
    assert not dist.is_initialized()      # run_pair closed the rank-only group


def test_skip_matrix_equals_the_reference(ref):
    rcfgs = ref[1]
    runnable, skipped = 0, {}
    for arch in tcfgs.ARCHS:
        for shape in tcfgs.SHAPES:
            want = rcfgs.skip_reason(rcfgs.get_config(arch), rcfgs.SHAPES[shape])
            if want is None:
                assert tcfgs.skip_reason(tcfgs.get_config(arch), tcfgs.SHAPES[shape]) is None
                runnable += 1
                continue
            rec = run_pair(arch, shape, verbose=False)
            assert rec["status"] == "skip" and rec["skip_reason"] == want
            skipped[(arch, shape)] = want
    assert runnable == 32 and len(skipped) == 8


def _ref_local_bytes(jax, leaves_with_specs, mesh_sizes):
    """Bytes on one rank of ShapeDtypeStructs laid out by PartitionSpecs."""
    total = 0
    for leaf, spec in leaves_with_specs:
        n = math.prod(leaf.shape)
        for axes in tuple(spec):
            for a in ((axes,) if isinstance(axes, str) else tuple(axes or ())):
                n //= mesh_sizes[a]
        total += n * np.dtype(leaf.dtype).itemsize
    return total


def test_full_pair_argument_bytes_equal_the_reference_rules(ref, monkeypatch):
    """qwen2-0.5b train_4k on 16x16 at full width: the record's argument bytes
    (params, AdamW moments, batch) are those of the JAX package's rules."""
    jax, rcfgs, rmodels, rsh = ref[:4]

    class StandIn:
        shape = {"data": 16, "model": 16}
        axis_names = ("data", "model")

    monkeypatch.setattr(rsh, "NamedSharding", lambda mesh, spec: spec)
    rcfg = rcfgs.get_config("qwen2-0.5b")
    shapes = jax.eval_shape(lambda: rmodels.init_params(rcfg, jax.random.PRNGKey(0)))
    pairs = []

    def one(path, leaf):
        keys = tuple(str(getattr(p, "key", p)) for p in path)
        spec = rsh._moe_fix(keys, leaf, rcfg, StandIn, rsh.param_pspec(keys, leaf, rcfg, StandIn))
        pairs.append((leaf, spec))

    jax.tree_util.tree_map_with_path(one, shapes)
    f32 = [(jax.ShapeDtypeStruct(leaf.shape, np.float32), spec) for leaf, spec in pairs]
    batch = rcfgs.input_specs(rcfg, "train_4k")["batch"]
    b_spec = rsh.batch_shardings(rcfg, batch, StandIn)
    want = _ref_local_bytes(jax, pairs + 2 * f32 + [(batch[k], b_spec[k]) for k in batch],
                            StandIn.shape)
    rec = run_pair("qwen2-0.5b", "train_4k", verbose=False)
    _check_record(rec)
    assert rec["memory"]["argument_bytes"] == want
    assert rec["param_count"] == rcfg.param_count()


def _smoke_inputs(arch, batch=4, seq=32, dtype="float32"):
    cfg = tcfgs.get_smoke(arch).replace(dtype=dtype)
    g = torch.Generator().manual_seed(0)
    params = init_params(cfg, g)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g, dtype=torch.int32)
    return cfg, params, adamw_init(params), {"tokens": tokens, "labels": tokens.clone()}


def _placed_step(cfg, params, opt, batch, mesh):
    p_shard = tsh.params_shardings(cfg, params, mesh)
    dp = tsh.place(copy.deepcopy(params), p_shard, mesh)
    do = tsh.place(copy.deepcopy(opt), tsh.opt_shardings(cfg, opt, mesh, p_shard), mesh)
    db = tsh.place(batch, tsh.batch_shardings(cfg, batch, mesh), mesh)
    with tsh.step_context(dp):
        return make_train_step(cfg)(dp, do, db), (dp, do, db)


def test_meta_count_equals_the_real_count_and_the_analytic_one():
    """One SMOKE train step on a (1, 1) mesh: the operations counted on meta
    tensors, on real CPU DTensors, and by formula.  Under ``_remat`` each
    layer's forward runs again in the backward, except its last product, the
    MLP's w_down, whose output the backward does not need (the checkpoint's
    recompute stops early); the head runs once and its backward twice."""
    cfg, params, opt, batch = _smoke_inputs("qwen2-0.5b")
    b, s = batch["tokens"].shape
    with rank_only_group(1):
        meta = trace_pair(cfg, InputShape("t", s, b, "train"), make_mesh((1, 1)))
    with local_group("cpu"):
        mesh = make_local_mesh(1, 1, device="cpu")
        p_shard = tsh.params_shardings(cfg, params, mesh)
        args = (tsh.place(params, p_shard, mesh),
                tsh.place(opt, tsh.opt_shardings(cfg, opt, mesh, p_shard), mesh),
                tsh.place(batch, tsh.batch_shardings(cfg, batch, mesh), mesh))
        with tsh.step_context(args[0]), RankCounter(args) as real:
            make_train_step(cfg)(*args)
    T, L, d, f, V = b * s, cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    layer = 2 * T * (d * (hq + 2 * hkv) * dh + hq * dh * d + 3 * d * f) + 4 * b * hq * s * s * dh
    analytic = 4 * L * layer - L * 2 * T * f * d + 3 * 2 * T * d * V
    assert meta["flops"] == real.flops == analytic
    assert meta["census"]["total_bytes"] == 0 and real.census()["total_bytes"] == 0
    assert meta["argument_bytes"] == sum(t.numel() * t.element_size()
                                         for t in tree_leaves((params, opt.m, opt.v, batch)))


def test_perf_pairs_equal_the_reference():
    """The JAX package's PAIRS, read from its source: importing that module
    would set XLA_FLAGS in this process."""
    tree = ast.parse((ROOT / "src/repro/launch/perf.py").read_text())
    want = None
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "PAIRS":
            want = {k.value: [e.value for e in v.elts[1].elts]
                    for k, v in zip(node.value.keys, node.value.values)}
    assert want and {k: v for k, (_, v) in perf.PAIRS.items()} == want


def test_fsdp_act_pins_the_hidden_states():
    """qwen2-0.5b SMOKE, fsdp profile with act_batch_axes=("data", "model") on
    (2, 2): each hidden state is redistributed to (Shard(0), Shard(0)).
    DTensor then keeps the column- and row-parallel weights sharded and takes
    each pending sum of a row-parallel product straight into the batch shard,
    a reduce-scatter of the (b/4, s, d) hidden state, where XLA gathers the
    weights (the JAX package's perf.py:39-44).  So no hidden state is
    all-reduced, where the tp profile all-reduces (b/2, s, d) hidden states
    in every layer, forward and backward (six a layer with torch 2.13)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    cfg = tcfgs.get_smoke("qwen2-0.5b")
    b, s, d = 8, 64, cfg.d_model
    act = cfg.replace(act_batch_axes=("data", "model"))
    shape = InputShape("t", s, b, "train")
    with rank_only_group(4):
        mesh = make_mesh((2, 2))
        x = distribute_tensor(torch.empty(b, s, d, device="meta"), mesh, [Shard(0), Replicate()])
        assert _act_constraint(x, act).placements == (Shard(0), Shard(0))
        assert _act_constraint(x, cfg) is x

    def hidden(cfg, profile, rows):
        got = _collectives(cfg, shape, profile)
        return {kind: sum(shapes == ((rows, s, d),) for k, _, shapes in got if k == kind)
                for kind in ("all-reduce", "reduce-scatter")}

    deeper = cfg.replace(num_layers=2 * cfg.num_layers)
    tp = hidden(cfg, "tp", b // 2)["all-reduce"]
    assert hidden(deeper, "tp", b // 2)["all-reduce"] - tp >= 2 * cfg.num_layers
    pinned = hidden(act, "fsdp", b // 4)
    assert pinned["reduce-scatter"] > 0
    assert hidden(act, "fsdp", b // 2)["all-reduce"] == pinned["all-reduce"] == 0


def _collectives(cfg, shape, profile):
    """RankCounter.collectives of one traced step on a (2, 2) mesh."""
    seen = []
    with rank_only_group(4):
        original = RankCounter.census
        try:
            RankCounter.census = lambda self: seen.extend(self.collectives) or {}
            trace_pair(cfg, shape, make_mesh((2, 2)), profile=profile)
        finally:
            RankCounter.census = original
    return seen


def test_world1_step_is_the_plain_step_and_the_reference(ref):
    """A (1, 1) CPU mesh of one gloo rank: the DTensor step equals the plain
    step bit for bit, and both are within CODED_GRAD_TOL of the JAX package's
    step, jitted with its own shardings on ``make_cpu_mesh(1, 1)``."""
    jax, rcfgs, rmodels, rsh, rmesh, rcoded, roptim = ref
    rcfg = rcfgs.get_smoke("qwen2-0.5b")
    jparams = rmodels.init_params(rcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, rcfg.vocab_size, (4, 32), dtype=np.int32)
    jbatch = {"tokens": tokens, "labels": tokens}
    rmesh_ = rmesh.make_cpu_mesh(1, 1)
    p_sh = rsh.params_shardings(rcfg, jax.eval_shape(lambda: jparams), rmesh_)
    jopt = roptim.adamw_init(jparams)
    o_sh = rsh.opt_shardings(rcfg, jax.eval_shape(lambda: jopt), rmesh_, p_sh)
    b_sh = rsh.batch_shardings(rcfg, jax.eval_shape(lambda: jbatch), rmesh_)
    with rmesh_:
        jstep = jax.jit(rcoded.make_train_step(rcfg), in_shardings=(p_sh, o_sh, b_sh),
                        out_shardings=(p_sh, o_sh, rsh.replicated(rmesh_)))
        want_params, _, want = jstep(jparams, jopt, jbatch)

    cfg = tcfgs.get_smoke("qwen2-0.5b")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    opt = adamw_init(params)
    batch = {k: torch.from_numpy(v.copy()) for k, v in jbatch.items()}
    plain_params, _, plain = make_train_step(cfg)(copy.deepcopy(params), copy.deepcopy(opt),
                                                  batch)
    with local_group("cpu"):
        (got_params, got_opt, got), _ = _placed_step(cfg, params, opt, batch,
                                                     make_local_mesh(1, 1, device="cpu"))
        got_params = tree_map(lambda t: t.full_tensor(), got_params)
        got_loss = got["loss"].full_tensor()
    assert torch.equal(got_loss, plain["loss"])
    for a, b in zip(tree_leaves(got_params), tree_leaves(plain_params)):
        assert torch.equal(a, b)
    assert float(got_loss) == pytest.approx(float(want["loss"]), rel=CODED_GRAD_TOL["rtol"])
    want_params = params_from_jax(jax.tree.map(np.asarray, want_params), cfg, device="cpu")
    for a, b in zip(tree_leaves(got_params), tree_leaves(want_params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **CODED_GRAD_TOL)


# the 4-process run: a dense step, and a moe step over two capacity groups of
# 1024 tokens, one a data rank, which drop pairs
SHARDED = {"qwen2-0.5b": dict(batch=4, seq=32), "qwen2-moe-a2.7b": dict(batch=4, seq=512)}


def _gloo_worker(rank: int, port: int, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=4)
    try:
        mesh = make_local_mesh(2, 2, device="cpu")
        results = {}
        for arch, kw in SHARDED.items():
            cfg, params, opt, batch = _smoke_inputs(arch, **kw)
            (p, _, metrics), _ = _placed_step(cfg, params, opt, batch, mesh)
            results[arch] = (metrics["loss"].full_tensor(), tree_map(lambda t: t.full_tensor(), p))
        if rank == 0:
            torch.save(results, out)
    finally:
        dist.destroy_process_group()


def test_four_gloo_ranks_match_one_process(tmp_path):
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out = str(tmp_path / "sharded.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_gloo_worker, args=(r, port, out)) for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    got = torch.load(out)
    for arch, kw in SHARDED.items():
        cfg, params, opt, batch = _smoke_inputs(arch, **kw)
        want_params, _, want = make_train_step(cfg)(params, opt, batch)
        loss, got_params = got[arch]
        assert float(loss) == pytest.approx(float(want["loss"]), rel=CODED_GRAD_TOL["rtol"])
        for a, b in zip(tree_leaves(got_params), tree_leaves(want_params)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **CODED_GRAD_TOL)


# -- on the card -------------------------------------------------------------------


@pytest.mark.cuda
def test_sharded_step_on_card_is_the_plain_step():
    """SMOKE qwen2-0.5b in bf16 on a (1, 1) NCCL mesh: three DTensor steps
    through the kernels equal three plain steps bit for bit, loss and every
    updated leaf, with the same kernel launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm, rmsnorm_bwd

    cfg, params, opt, batch = _smoke_inputs("qwen2-0.5b", dtype="bfloat16", seq=64)
    dev = torch.device("cuda", 0)
    params = tree_map(lambda t: t.to(dev), params)
    batch = tree_map(lambda t: t.to(dev), batch)
    opt = adamw_init(params)
    kernels = (flash_attention, flash_attention_bwd, rmsnorm, rmsnorm_bwd)

    def launches():
        return [k.launches for k in kernels]

    step = make_train_step(cfg)
    p, o = copy.deepcopy(params), copy.deepcopy(opt)
    before = launches()
    losses = []
    for _ in range(3):
        p, o, m = step(p, o, batch)
        losses.append(m["loss"])
    plain = [a - b for a, b in zip(launches(), before)]
    with local_group("cuda"):
        mesh = make_local_mesh(1, 1)
        p_shard = tsh.params_shardings(cfg, params, mesh)
        dp = tsh.place(copy.deepcopy(params), p_shard, mesh)
        do = tsh.place(copy.deepcopy(opt), tsh.opt_shardings(cfg, opt, mesh, p_shard), mesh)
        db = tsh.place(batch, tsh.batch_shardings(cfg, batch, mesh), mesh)
        before = launches()
        with tsh.step_context(dp):
            for i in range(3):
                dp, do, m = step(dp, do, db)
                assert torch.equal(m["loss"].full_tensor(), losses[i])
        sharded = [a - b for a, b in zip(launches(), before)]
        for a, b in zip(tree_leaves(dp), tree_leaves(p)):
            assert torch.equal(a.full_tensor(), b)
    assert sharded == plain and all(plain)
