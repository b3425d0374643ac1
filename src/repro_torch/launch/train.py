"""Training launcher.  Port of ``src/repro/launch/train.py``.

Two modes:
  * ``--demo``: multi-model coded training (the paper's §4.2 experiment):
    M models trained interleaved under GC / SR-SGC / M-SGC / uncoded with a
    Gilbert-Elliott straggler source, reporting the scheme's simulated
    runtime and real training losses (``train_demo``).
  * ``--arch``: uncoded or GC-coded train steps of one model
    (``train_arch``), at the smoke size or, with ``--full``, at full width
    and full depth.  On the card the dense, moe, ssm and hybrid families
    train (mamba2-1.3b, zamba2-2.7b: the fused SSD chunk scan forward and
    backward kernels; qwen2-moe-a2.7b and mixtral-8x22b: attention at head
    dim 128, the experts through cuBLAS).  At full depth qwen2-moe-a2.7b's
    training state is ~172 GB and mixtral-8x22b's ~1.7 TB, more than one
    card holds: ``chip_smoke.py``'s ``[slice-moe-train]`` runs these steps at
    full width with the depth cut (3 and 1 layers).  The uncoded step's one
    group of 512 tokens drops (token, expert) pairs, as the JAX package's
    does; the coded step's chunks of 128 tokens drop none.  The vlm and
    hubert-xlarge take patch embeddings and frames, not tokens, so this
    entry point refuses them; the vlm trains on the card through
    ``make_coded_train_step`` (``chip_smoke.py``'s ``[slice-vlm-train]``:
    full-width, full-depth paligemma-3b, attention forward and backward at
    head dim 256), and hubert's training waits for the attention backward's
    redesign at head dim 80 (ROADMAP B-4).

Runs on the card unless ``--device cpu`` is given; with no card it raises
rather than fall back.

  PYTHONPATH=src python -m repro_torch.launch.train --demo --scheme m-sgc --jobs 60
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --steps 3 --coded
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b --full --coded
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-moe-a2.7b --coded --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --demo --device cpu

On the CPU, ``tests/test_torch_moe_train.py`` holds the moe family's coded
and uncoded steps and ``VectorizedCodedTrainer`` to the JAX package at the
smoke size; on the card, ``chip_smoke.py``'s ``[slice-moe-train]`` runs
them at full width and cut depth.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.core import GilbertElliotSource, make_gradient_code, make_scheme
from repro_torch.data import gc_chunked_batch, token_batch
from repro_torch.devices import resolve_device
from repro_torch.train import (
    CodedTrainingDriver,
    gc_round_weights,
    init_train_state,
    make_coded_train_step,
    make_train_step,
)
from repro_torch.tree import tree_leaves

DEMO_SCHEMES = ("gc", "sr-sgc", "m-sgc", "uncoded")


@dataclass(frozen=True)
class DemoResult:
    clock: float                 # simulated runtime of the scheme
    wall_s: float                # host clock of the run
    final_losses: list           # each model's last loss
    driver: CodedTrainingDriver
    max_decode_err: float | None  # with check_decodes: worst |decoded - full_gradient|


def demo_scheme_kwargs(scheme_name: str, n: int) -> dict:
    return {
        "gc": dict(s=max(1, n // 8)),
        "sr-sgc": dict(B=1, W=2, lam=max(2, n // 4)),
        "m-sgc": dict(B=1, W=2, lam=max(2, n // 4)),
        "uncoded": {},
    }[scheme_name]


def check_decodes_of(drv: CodedTrainingDriver) -> list:
    """Hold every gradient ``drv`` decodes from now on against the direct
    full-batch gradient at the job's snapshot (each check decodes the job a
    second time).  Returns the list the worst absolute difference of each
    decoded job is appended to."""
    worst = []
    apply_update = drv._apply_update

    def checked(jd):
        got, want = drv.decode_gradient(jd), drv.full_gradient(jd.job)
        worst.append(max(float((a - b).abs().max())
                         for a, b in zip(tree_leaves(got), tree_leaves(want))))
        apply_update(jd)

    drv._apply_update = checked
    return worst


def train_demo(scheme_name: str = "m-sgc", jobs: int = 40, n: int = 16, models: int = 4,
               seed: int = 0, *, device="cuda", check_decodes: bool = False) -> DemoResult:
    """Run ``jobs`` jobs of the multi-model coded MLP training.

    With ``check_decodes``, every decoded gradient is also held against the
    direct full-batch gradient at the job's snapshot, and the worst absolute
    difference is returned (each such check decodes the job a second time).
    """
    dev = resolve_device(device)
    sch = make_scheme(scheme_name, n, jobs, **demo_scheme_kwargs(scheme_name, n))
    drv = CodedTrainingDriver(scheme=sch, num_models=models, batch_size=256, lr=5e-3,
                              seed=seed, device=dev)
    delays = GilbertElliotSource(n=n, seed=seed).sample_delays(jobs + sch.T + 1)
    worst = check_decodes_of(drv) if check_decodes else None
    t0 = time.perf_counter()
    clock = drv.run(jobs, delays)
    wall = time.perf_counter() - t0
    final = [drv.losses[m][-1] for m in range(models)]
    print(
        f"scheme={scheme_name:8s} load={sch.normalized_load:.4f} T={sch.T} "
        f"simulated_runtime={clock:8.1f}s wall={wall:5.1f}s "
        f"final_losses={[f'{loss:.3f}' for loss in final]} on {dev}"
    )
    return DemoResult(clock, wall, final, drv, max(worst) if worst else None)


def train_arch(arch: str = "qwen2-0.5b", steps: int = 3, coded: bool = False, seed: int = 0,
               *, full: bool = False, device="cuda") -> list[float]:
    """``steps`` train steps of one model on 8 sequences of 64 tokens; coded
    steps run (4, 1)-GC with a random straggler each round.  Returns the losses."""
    dev = resolve_device(device)
    cfg = get_config(arch) if full else get_smoke(arch)
    if cfg.frontend != "none":
        raise NotImplementedError(f"train_arch draws token batches only; {cfg.name} takes "
                                  f"{cfg.frontend} inputs (see ROADMAP.md A-6b)")
    params, opt = init_train_state(cfg, torch.Generator(device=dev).manual_seed(seed))
    losses = []
    if coded:
        n, s = 4, 1
        code = make_gradient_code(n, s)
        step = make_coded_train_step(cfg, n, s)
        rng = np.random.default_rng(seed)
        for i in range(steps):
            coded_batch = gc_chunked_batch(token_batch(seed, i, 8, 64, cfg.vocab_size,
                                                       device=dev), n, s)
            # random straggler each round (tolerates s=1)
            surv = sorted(rng.choice(n, size=n - 1, replace=False).tolist())
            w = gc_round_weights(code, surv).to(dev)
            params, opt, m = step(params, opt, coded_batch, w)
            losses.append(float(m["loss"]))
            print(f"step {i}: loss={losses[-1]:.4f} survivors={surv}")
    else:
        step = make_train_step(cfg)
        for i in range(steps):
            params, opt, m = step(params, opt, token_batch(seed, i, 8, 64, cfg.vocab_size,
                                                           device=dev))
            losses.append(float(m["loss"]))
            print(f"step {i}: loss={losses[-1]:.4f}")
    return losses


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--scheme", default="m-sgc", choices=list(DEMO_SCHEMES))
    ap.add_argument("--jobs", type=int, default=40)
    ap.add_argument("--workers", type=int, default=16)
    ap.add_argument("--models", type=int, default=4)
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--coded", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="the full-width config instead of the smoke one (--arch)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    if args.demo:
        train_demo(args.scheme, args.jobs, args.workers, args.models, args.seed,
                   device=args.device)
    elif args.arch:
        train_arch(args.arch, args.steps, args.coded, args.seed, full=args.full,
                   device=args.device)
    else:
        raise SystemExit("pass --demo or --arch")


if __name__ == "__main__":
    main()
