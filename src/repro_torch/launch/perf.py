"""The §Perf hillclimbing runs.  Port of ``src/repro/launch/perf.py``.

Runs the selected (arch x shape) pairs through their iteration variants
(sharding profile, cache layout, coded operating point, activation pinning,
remat policy) and records each variant's dry-run record (``dryrun.run_pair``:
counts on meta tensors, no device) under a tag, so that the records of one
pair can be set side by side.

  PYTHONPATH=src python -m repro_torch.launch.perf --pair qwen05 --variant fsdp
  PYTHONPATH=src python -m repro_torch.launch.perf --all

Pairs, as the JAX package chose them:
  qwen05   qwen2-0.5b    train_4k               baseline, fsdp, fsdp-act, fsdp-act-dots
  mixtral  mixtral-8x22b decode_32k + long_500k baseline, headdim (cache layout)
  coded    llama3.2-1b   train_4k               GC (s=15) vs M-SGC (load 2/n), with fsdp
                                                and activation pinning
  mamba    mamba2-1.3b   train_4k               baseline, fsdp-act
  qwen72   qwen2-72b     train_4k               baseline, dots
  prefill  qwen2-0.5b    prefill_32k            baseline, seqpar (sequence parallel)
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_config

from .dryrun import run_pair

OUT = "experiments/perf_torch"


def pair_qwen05(variants, out=OUT):
    arch, shape = "qwen2-0.5b", "train_4k"
    if "baseline" in variants:
        run_pair(arch, shape, out_dir=out, tag="baseline")
    if "fsdp" in variants:
        run_pair(arch, shape, out_dir=out, tag="fsdp", profile="fsdp")
    if "fsdp-act" in variants:
        # activations pinned batch-sharded so that params (not activations) move
        cfg = get_config(arch).replace(act_batch_axes=("data", "model"))
        run_pair(arch, shape, out_dir=out, tag="fsdp-act", profile="fsdp", cfg=cfg)
    if "fsdp-act-dots" in variants:
        cfg = get_config(arch).replace(act_batch_axes=("data", "model"), remat_policy="dots")
        run_pair(arch, shape, out_dir=out, tag="fsdp-act-dots", profile="fsdp", cfg=cfg)


def pair_mixtral(variants, out=OUT):
    arch = "mixtral-8x22b"
    for shape in ("decode_32k", "long_500k"):
        if "baseline" in variants:
            run_pair(arch, shape, out_dir=out, tag="baseline")
        if "headdim" in variants:
            run_pair(arch, shape, out_dir=out, tag="headdim", cache_mode="headdim")


def pair_coded(variants, out=OUT):
    arch, shape = "llama3.2-1b", "train_4k"
    if "baseline" in variants:
        run_pair(arch, shape, out_dir=out, coded="gc", tag="gc-baseline")
    if "msgc" in variants:
        run_pair(arch, shape, out_dir=out, coded="msgc", tag="msgc")
    if "msgc-fsdp" in variants:
        run_pair(arch, shape, out_dir=out, coded="msgc", tag="msgc-fsdp", profile="fsdp")
    if "gc-fsdp" in variants:
        run_pair(arch, shape, out_dir=out, coded="gc", tag="gc-fsdp", profile="fsdp")
    if "msgc-act" in variants:
        # the M-SGC operating point with FSDP activation pinning
        cfg = get_config(arch).replace(act_batch_axes=("data", "model"))
        run_pair(arch, shape, out_dir=out, coded="msgc", tag="msgc-act", profile="fsdp",
                 cfg=cfg)
    if "gc-act" in variants:
        cfg = get_config(arch).replace(act_batch_axes=("data", "model"))
        run_pair(arch, shape, out_dir=out, coded="gc", tag="gc-act", profile="fsdp", cfg=cfg)


def pair_mamba(variants, out=OUT):
    arch, shape = "mamba2-1.3b", "train_4k"
    if "baseline" in variants:
        run_pair(arch, shape, out_dir=out, tag="baseline")
    if "fsdp-act" in variants:
        cfg = get_config(arch).replace(act_batch_axes=("data", "model"))
        run_pair(arch, shape, out_dir=out, tag="fsdp-act", profile="fsdp", cfg=cfg)


def pair_qwen72(variants, out=OUT):
    arch, shape = "qwen2-72b", "train_4k"
    if "baseline" in variants:
        run_pair(arch, shape, out_dir=out, tag="baseline")
    if "dots" in variants:
        cfg = get_config(arch).replace(remat_policy="dots")
        run_pair(arch, shape, out_dir=out, tag="dots", cfg=cfg)


def pair_prefill(variants, out=OUT):
    arch, shape = "qwen2-0.5b", "prefill_32k"
    if "baseline" in variants:
        run_pair(arch, shape, out_dir=out, tag="baseline")
    if "seqpar" in variants:
        # Megatron sequence parallelism: activations sharded over (batch=data,
        # seq=model); the attention gathers its keys and values
        cfg = get_config(arch).replace(act_batch_axes=("data",), act_seq_axis="model")
        run_pair(arch, shape, out_dir=out, tag="seqpar", cfg=cfg)


PAIRS = {
    "qwen72": (pair_qwen72, ["baseline", "dots"]),
    "prefill": (pair_prefill, ["baseline", "seqpar"]),
    "qwen05": (pair_qwen05, ["baseline", "fsdp", "fsdp-act", "fsdp-act-dots"]),
    "mixtral": (pair_mixtral, ["baseline", "headdim"]),
    "coded": (pair_coded, ["baseline", "msgc", "msgc-fsdp", "gc-fsdp", "msgc-act", "gc-act"]),
    "mamba": (pair_mamba, ["baseline", "fsdp-act"]),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pair", choices=list(PAIRS))
    ap.add_argument("--variant", action="append", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()

    targets = list(PAIRS) if args.all else [args.pair]
    for t in targets:
        fn, default_variants = PAIRS[t]
        fn(args.variant or default_variants, out=args.out)


if __name__ == "__main__":
    main()
