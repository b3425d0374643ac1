"""The multi-pod dry-run.  Port of ``src/repro/launch/dryrun.py``.

Traces every (architecture x input-shape) pair's step against the production
meshes, 16x16 = 256 ranks single-pod and 2x16x16 = 512 ranks multi-pod, on
meta DTensors over the rank-only group (``mesh.rank_only_group``): the shapes
are real and nothing is allocated or sent.  Where the JAX package lowers and
compiles the step and reads XLA's memory and cost analyses and the HLO's
collectives, the port runs the step eagerly under ``comm_census.RankCounter``
and records what rank 0 ran: its matrix operations, the bytes its ops moved,
its collectives, and the bytes it held.  These are counts on meta tensors, on
no device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--coded]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --coded

``--coded`` also traces the GC-coded train step (the paper's technique on the
production mesh) for train shapes.  Importing this module sets nothing: the
rank-only group opens inside ``run_pair`` and closes after it, and a group the
caller opened is left alone.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import torch

from repro_torch.configs import ARCHS, SHAPES, InputShape, get_config, input_specs, skip_reason
from repro_torch.models import decode_step, forward, init_params
from repro_torch.optim import adamw_init
from repro_torch.train.coded import make_coded_train_step, make_train_step

from .comm_census import RankCounter, local_bytes
from .mesh import MULTI_POD, SINGLE_POD, make_mesh, rank_only_group
from .sharding import (
    batch_shardings,
    cache_shardings,
    opt_shardings,
    params_shardings,
    place,
    replicated,
    step_context,
)

COUNTED_ON = "meta tensors, no device"


def _coded_shape(shape: InputShape, coded) -> tuple[int, int, int]:
    """(n, s, cb) of the coded step, as the JAX package forms them: n = min(256,
    batch) logical workers; "gc": the Table-1 operating point s = 15 at n = 256
    (load (s+1)/n = 0.0625); "msgc": the lambda = n M-SGC round, one
    re-attempt slot (s = 1, load 2/n); cb = batch // n sequences a chunk."""
    n = min(256, shape.global_batch)
    s = 1 if coded == "msgc" else max(1, round(0.0625 * n) - 1)
    return n, s, shape.global_batch // n


def trace_pair(cfg, shape, mesh, *, coded: bool | str = False, profile: str = "tp",
               cache_mode: str = "auto") -> dict:
    """Run one (arch, shape) step on meta DTensors over ``mesh`` under a
    ``RankCounter``.  ``shape`` is a name of ``SHAPES`` or an ``InputShape``.

    coded: False -> the plain train step; "gc" / True -> the (n, s=15) GC-coded
    step; "msgc" -> the M-SGC round (``_coded_shape``).  prefill runs
    ``forward`` without gradients; decode one ``decode_step`` (the serve
    step) at pos = seq_len - 1, the cache full (the port's pos is an int).

    Returns the counter's readings: ``flops``, ``bytes``, ``census``,
    ``argument_bytes`` and ``output_bytes`` (local shards), ``temp_bytes`` (the
    peak of the storages the step made), ``seconds``.
    """
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    specs = input_specs(cfg, shape)
    params0 = init_params(cfg, None)
    p_shard = params_shardings(cfg, params0, mesh)
    params = place(params0, p_shard, mesh)

    def with_adamw():
        opt0 = adamw_init(params0)
        return place(opt0, opt_shardings(cfg, opt0, mesh, p_shard), mesh)

    if shape.mode == "decode":
        cache = place(specs["cache"], cache_shardings(cfg, specs["cache"], mesh,
                                                      mode=cache_mode), mesh)
        token = place(specs["token"], batch_shardings(cfg, {"t": specs["token"]}, mesh)["t"],
                      mesh)
        args = (params, cache, token, shape.seq_len - 1)

        def step(p, c, t, pos):
            # decode_step's body under no_grad: under its own inference mode,
            # DTensor (torch 2.13) runs an op whose sharding it has cached
            # where no dispatch mode sees its local ops, and the count would
            # depend on what ran before
            with torch.no_grad():
                return decode_step.__wrapped__(p, cfg, c, t, pos)
    elif coded:
        n, s, cb = _coded_shape(shape, coded)
        batch = {k: torch.empty((n, s + 1, cb) + v.shape[1:], dtype=v.dtype, device="meta")
                 for k, v in specs["batch"].items()}
        batch = place(batch, batch_shardings(cfg, batch, mesh, profile=profile), mesh)
        weights = place(torch.empty((n, s + 1), device="meta"), replicated(mesh), mesh)
        args = (params, with_adamw(), batch, weights)
        step = make_coded_train_step(cfg, n, s)
    else:
        batch = place(specs["batch"], batch_shardings(cfg, specs["batch"], mesh,
                                                      profile=profile), mesh)
        if shape.mode == "prefill":
            args = (params, batch)

            def step(p, b):
                with torch.no_grad():
                    return forward(p, cfg, b)[0]
        else:
            args = (params, with_adamw(), batch)
            step = make_train_step(cfg)

    t0 = time.perf_counter()
    with step_context(params), RankCounter(args) as counter:
        out = step(*args)
    seconds = time.perf_counter() - t0
    return {
        "flops": counter.flops,
        "bytes": counter.bytes,
        "census": counter.census(),
        "argument_bytes": local_bytes(args),
        "output_bytes": local_bytes(out),
        "temp_bytes": counter.peak,
        "seconds": seconds,
    }


def run_pair(arch: str, shape_name: str, *, multi_pod: bool = False,
             coded: bool | str = False, out_dir: str | None = None,
             verbose: bool = True, cfg=None, tag: str = "",
             profile: str = "tp", cache_mode: str = "auto",
             mesh_shape: tuple | None = None) -> dict:
    """One pair's record, with the JAX package's keys (module docstring for
    what each counts here), written to ``out_dir`` when one is given.
    ``mesh_shape`` (2 or 3 axes) replaces the production mesh of
    ``multi_pod``, and an ``InputShape`` may stand for a name of ``SHAPES``
    (small shapes for tests)."""
    cfg = cfg if cfg is not None else get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    shape_name = shape.name
    reason = skip_reason(cfg, shape)
    mesh_shape = tuple(mesh_shape or (MULTI_POD if multi_pod else SINGLE_POD))
    mesh_name = "x".join(map(str, mesh_shape))
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "coded": coded,
        "tag": tag,
        "status": "skip" if reason else "ok",
        "skip_reason": reason,
    }
    if reason:
        if verbose:
            print(f"[dryrun] {arch:16s} {shape_name:12s} {mesh_name:8s} SKIP: {reason}")
        _dump(record, out_dir)
        return record

    ndev = math.prod(mesh_shape)
    with rank_only_group(ndev):
        mesh = make_mesh(mesh_shape)
        got = trace_pair(cfg, shape, mesh, coded=coded, profile=profile,
                         cache_mode=cache_mode)
    record.update(
        {
            "lower_s": round(got["seconds"], 2),
            "compile_s": None,
            "num_devices": ndev,
            # the port's layer loop is a Python loop, so the counts are of
            # every layer: the JAX package's scanned and unrolled counts agree
            "flops_per_device_scanned": got["flops"],
            "bytes_per_device_scanned": got["bytes"],
            "flops_per_device": got["flops"],
            "bytes_per_device": got["bytes"],
            "unrolled": {"flops_total": got["flops"] * ndev, "bytes_total": got["bytes"] * ndev},
            "memory": {
                "argument_bytes": got["argument_bytes"],
                "output_bytes": got["output_bytes"],
                "temp_bytes": got["temp_bytes"],
            },
            "collectives": got["census"],
            "param_count": cfg.param_count(),
            "active_param_count": cfg.param_count(active_only=True),
            "counted_on": COUNTED_ON,
            "torch_version": torch.__version__,
        }
    )
    if shape.mode == "decode":
        record["decode_pos"] = shape.seq_len - 1
    if cfg.family == "moe":
        record["moe_rows"] = "G x Cg an expert, the capacity form (no routing on meta)"
    if verbose:
        print(
            f"[dryrun] {arch:16s} {shape_name:12s} {mesh_name:8s} "
            f"trace {record['lower_s']:6.1f}s  "
            f"flops/dev {record['flops_per_device']:.3e}  "
            f"coll {record['collectives']['total_bytes'] / 2**30:.2f} GiB"
        )
    _dump(record, out_dir)
    return record


def _dump(record: dict, out_dir: str | None):
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    coded = record.get("coded")
    suffix = "" if not coded else ("_coded" if coded is True or coded == "gc"
                                   else f"_coded-{coded}")
    if record.get("tag"):
        suffix += f"_{record['tag']}"
    name = f"{record['arch']}_{record['shape']}_{record['mesh']}{suffix}.json"
    with open(os.path.join(out_dir, name.replace("/", "-")), "w") as f:
        json.dump(record, f, indent=2)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--coded", action="store_true",
                    help="also trace the GC-coded train step")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args()

    pairs = (
        [(a, s) for a in ARCHS for s in SHAPES]
        if args.all
        else [(args.arch, args.shape)]
    )
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    t0 = time.perf_counter()
    for arch, shape in pairs:
        for mp in meshes:
            try:
                run_pair(arch, shape, multi_pod=mp, out_dir=args.out)
                if args.coded and SHAPES[shape].mode == "train":
                    run_pair(arch, shape, multi_pod=mp, coded=True, out_dir=args.out)
            except Exception as e:  # noqa: BLE001  (one pair's failure is recorded, the rest run)
                failures.append((arch, shape, mp, repr(e)))
                print(f"[dryrun] FAIL {arch} {shape} multi_pod={mp}: {e!r}")
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")
    print(f"[dryrun] all pairs traced OK in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
