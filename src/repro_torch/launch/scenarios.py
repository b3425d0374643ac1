"""The paper's Sec.-6 comparison on the port: all 7 schemes over the straggler
trace library.

Ports of what the repository runs outside the JAX package (the port imports
none of it, so these are copies):

* :func:`scheme_grid` — ``examples/multimodel_training.py``'s 7-scheme
  configuration at an n-worker cluster;
* :func:`multimodel_training` — that example's ``main``: M classifiers trained
  interleaved under each of the 7 schemes through ``CodedTrainingDriver``,
  whose GC encodes and decodes are ``coded_combine`` launches on the card;
* :func:`scenario_sweep` — ``benchmarks/run.py``'s ``bench_scenario_sweep``:
  one ``simulate_batch`` grid per scenario of ``trace_library``, with its two
  gates (equal load across the labels that share gc's tolerance, and dc-gc /
  sb-gc never slower than general gc);
* :func:`coded_train` — ``benchmarks/run.py``'s ``bench_coded_train``: the 7
  schemes through ``VectorizedCodedTrainer`` on ``ge-bursty`` and
  ``replayed-waves``, with its three gates (M-SGC's simulated clock below
  GC's on ``ge-bursty``, the measured M-SGC/GC step-time ratio below 1, every
  loss finite).

Each runs on the card unless the caller passes ``device="cpu"``; with no card
it raises.

  PYTHONPATH=src python -m repro_torch.launch.scenarios sweep [--n 64] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.scenarios train [--full] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.scenarios multimodel [--jobs 80] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.core import (
    GilbertElliotSource,
    make_scheme,
    simulate_batch,
    sr_sgc_s,
    trace_library,
)
from repro_torch.data import coded_slot_batch
from repro_torch.devices import resolve_device
from repro_torch.train import CodedTrainingDriver, VectorizedCodedTrainer

from .train import check_decodes_of

MU = 1.0  # benchmarks/run.py's mu-rule
ARCH = "qwen2-0.5b"


def scheme_grid(n: int) -> list[tuple[str, str, dict]]:
    """(label, scheme_name, kwargs) for all 7 registered schemes at an
    n-worker cluster, at comparable operating points: the per-round
    codes (gc-rep / gc / dc-gc / sb-gc) share the same tolerance ``s``
    (gc-rep rounds down to the nearest ``(s+1) | n``), M-SGC/SR-SGC use
    the B=1, W=2 point the paper's probe picks on short-burst profiles.
    """
    s = 3 if n <= 16 else n // 8
    s_rep = next(k for k in range(s, -1, -1) if n % (k + 1) == 0)
    lam = max(2, min(12, n // 4))
    C = 4 if n % 4 == 0 and s < n // 4 else 2
    return [
        ("m-sgc", "m-sgc", dict(B=1, W=2, lam=lam)),
        ("sr-sgc", "sr-sgc", dict(B=1, W=2, lam=lam)),
        ("gc-rep", "gc", dict(s=s_rep)),
        ("gc", "gc", dict(s=s, prefer_rep=False)),
        ("dc-gc", "dc-gc", dict(C=C, s=s)),
        ("sb-gc", "sb-gc", dict(C=C, s=s)),
        ("uncoded", "uncoded", {}),
    ]


#: ``bench_scenario_sweep``'s labeled specs (s = 3): gc-rep (App. G's default
#: at (s+1) | n) and general-code gc are separate baselines, since Rep's
#: coverage model is itself a superset tolerance; the dominance gate holds the
#: clustered baselines to the GENERAL code
SWEEP_SPECS = [
    ("m-sgc", "m-sgc", dict(B=1, W=2, lam=8)),
    ("sr-sgc", "sr-sgc", dict(B=1, W=2, lam=6)),  # s = 3: gc's load
    ("gc-rep", "gc", dict(s=3)),
    ("gc", "gc", dict(s=3, prefer_rep=False)),
    ("dc-gc", "dc-gc", dict(C=4, s=3)),
    ("sb-gc", "sb-gc", dict(C=4, s=3)),
    ("uncoded", "uncoded", {}),
]
#: ``bench_coded_train``'s batch of a job, its two traces of the library and
#: the calls its isolated step measurement times
CODED_BATCH = 32
CODED_TRACES = ("ge-bursty", "replayed-waves")
CODED_REPS = 10


def _tolerance(name: str, params: dict) -> int | None:
    """Per-round straggler tolerance s of a per-round spec, else None."""
    if name in ("gc", "dc-gc", "sb-gc"):
        return params["s"]
    if name == "sr-sgc":
        return sr_sgc_s(params["B"], params["W"], params["lam"])
    return None


# ---------------------------------------------------------------------------
# the scenario sweep
# ---------------------------------------------------------------------------


@dataclass
class SweepResult:
    specs: list                                   # (label, name, params)
    grids: dict = field(default_factory=dict)     # scenario -> (specs, 1, traces) SimResults
    means: dict = field(default_factory=dict)     # (scenario, label) -> mean per-job s
    walls: dict = field(default_factory=dict)     # scenario -> host seconds of its grid
    eq_load: tuple = ()                           # labels held to gc's load (s+1)/n


def scenario_sweep(n: int = 64, rounds: int = 40, num_traces: int = 4, specs=None, *,
                   seed: int = 0, device="cuda", quiet: bool = False) -> SweepResult:
    """Sec. 6: the paper's schemes against the dynamic-clustering (Buyukates
    et al.) and stochastic-block (Charles & Papailiopoulos) GC baselines over
    the straggler trace library (``trace_library(n, rounds, num_traces,
    seed)``), one ``simulate_batch`` grid per scenario on ``device``.

    ``specs`` are ``(label, scheme_name, params)``, ``SWEEP_SPECS`` by
    default; they must hold a general-code ``gc`` label.  Gates, which raise
    ``AssertionError`` as the bench's asserts do: (1) every
    label whose per-round tolerance equals gc's ``s`` runs at gc's normalized
    load ``(s+1)/n``; (2) at equal load the clustered baselines admit a
    superset of general GC's patterns per round, so dc-gc's and sb-gc's mean
    per-job time is at most gc's (+1e-9) on every scenario (checked where
    they share gc's ``s``).
    """
    dev = resolve_device(device)
    specs = list(SWEEP_SPECS if specs is None else specs)
    by_label = {label: (name, params) for label, name, params in specs}
    s = by_label["gc"][1]["s"]
    eq_load = tuple(label for label, name, params in specs if _tolerance(name, params) == s)
    out = SweepResult(specs=specs, eq_load=eq_load)
    lib = trace_library(n=n, rounds=rounds, num_traces=num_traces, seed=seed)
    t_all = time.perf_counter()
    for sc in lib:
        t0 = time.perf_counter()
        grid = simulate_batch([(name, params) for _, name, params in specs], sc.delays,
                              mu=MU, alpha=sc.alpha, device=dev)
        out.walls[sc.name] = time.perf_counter() - t0
        out.grids[sc.name] = grid
        for i, (label, _, _) in enumerate(specs):
            cells = list(grid[i].ravel())
            per_job = [r.total_time / len(r.job_done_round) for r in cells]
            load = cells[0].normalized_load
            out.means[(sc.name, label)] = float(np.mean(per_job))
            if not quiet:
                wo = float(np.mean([r.waitouts for r in cells]))
                print(f"scenario.{sc.name}.{label},{np.mean(per_job):.4f},"
                      f"per-job s (std={np.std(per_job):.4f} waitouts={wo:.1f} "
                      f"load={load:.4f})")
            if label in eq_load and abs(load - (s + 1) / n) >= 1e-12:
                raise AssertionError(f"{label} runs at load {load} on {sc.name}, not gc's "
                                     f"{(s + 1) / n}")
        if not quiet:
            order = sorted((out.means[(sc.name, lb)], lb) for lb, _, _ in specs)
            print(f"scenario.{sc.name}.winner,{order[0][1]},fastest per-job of "
                  f"{len(specs)} schemes ({out.walls[sc.name]:.3f} s on {dev})")
    if not quiet:
        print(f"scenario.sims,{len(lib) * len(specs) * num_traces},{len(lib)} scenarios x "
              f"{len(specs)} schemes x {num_traces} traces (n={n}) in "
              f"{time.perf_counter() - t_all:.1f}s")
    # equal-load dominance: per round, <= s total stragglers implies <= s per
    # cluster/block, so the clustered baselines can never run slower than
    # general gc on the same trace
    for sc in lib:
        for lb in ("dc-gc", "sb-gc"):
            if lb in eq_load and not (out.means[(sc.name, lb)]
                                      <= out.means[(sc.name, "gc")] + 1e-9):
                raise AssertionError(f"{lb} slower than general gc at equal load on {sc.name}")
    return out


# ---------------------------------------------------------------------------
# multi-model coded training: descriptor driver and vectorized trainer
# ---------------------------------------------------------------------------


@dataclass
class MultimodelRun:
    load: float
    T: int
    clock: float                 # simulated runtime
    final_losses: list           # each model's last loss
    driver: CodedTrainingDriver
    max_decode_err: float | None  # with check_decodes: worst |decoded - full-batch|


def multimodel_training(jobs: int = 80, workers: int = 64, models: int = 4, seed: int = 0, *,
                        check_decodes: bool = False, device="cuda",
                        quiet: bool = False) -> dict:
    """The paper's §4.2 experiment under all 7 schemes: ``models``
    classifiers trained interleaved (Remark 2.1), on batches of 256, on a
    ``workers``-worker cluster with bursty Gilbert-Elliott stragglers.
    Every gradient is computed and decoded (``coded_combine`` on the card); the wall clock is
    simulated from the delay profile.  Returns ``{label: MultimodelRun}``;
    with ``check_decodes`` every decoded gradient is also held against the
    full-batch one."""
    dev = resolve_device(device)
    delays = GilbertElliotSource(n=workers, p_ns=0.035, p_sn=0.85, slow_factor=6.0,
                                 seed=seed).sample_delays(jobs + 8)
    if not quiet:
        print(f"{'scheme':9s} {'load':>7s} {'T':>2s} {'sim runtime':>12s} "
              "final losses (M models)")
    out = {}
    for label, name, kw in scheme_grid(workers):
        sch = make_scheme(name, workers, jobs, **kw)
        drv = CodedTrainingDriver(scheme=sch, num_models=models, batch_size=256,
                                  lr=5e-3, seed=seed, device=dev)
        worst = check_decodes_of(drv) if check_decodes else None
        clock = drv.run(jobs, delays)
        finals = [drv.losses[m][-1] for m in range(models)]
        out[label] = MultimodelRun(sch.normalized_load, sch.T, clock, finals, drv,
                                   max(worst) if worst else None)
        if not quiet:
            print(f"{label:9s} {sch.normalized_load:7.4f} {sch.T:2d} {clock:11.1f}s  "
                  f"{[f'{x:.3f}' for x in finals]}")
    if not quiet:
        gain = 1 - out["m-sgc"].clock / out["gc"].clock
        print(f"\nM-SGC vs GC runtime gain: {gain:.1%} "
              "(paper Table 1: 16% on 256 Lambda workers)")
    return out


def tiny_config():
    """``bench_coded_train``'s model: qwen2-0.5b's smoke config cut to one
    64-wide layer and a 128-token vocabulary."""
    return get_smoke(ARCH).replace(num_layers=1, d_model=64, num_heads=2, num_kv_heads=1,
                                   head_dim=32, d_ff=128, vocab_size=128)


@dataclass
class CodedTrainResult:
    sim_clock: dict = field(default_factory=dict)   # (trace, label) -> simulated s
    step_ms: dict = field(default_factory=dict)     # (trace, label) -> run's median step ms
    isolated_ms: dict = field(default_factory=dict)  # label -> the gate's step ms
    final_loss: dict = field(default_factory=dict)  # (trace, label) -> mean last loss
    loads: dict = field(default_factory=dict)       # label -> normalized load
    steps: int = 0                                  # coded steps over every run
    ratio: float = float("nan")                     # M-SGC / GC isolated step ms


def coded_train(n: int = 8, models: int = 4, jobs: int = 24, *, cfg=None, seq_len: int = 8,
                lr: float = 1e-3, step_timer=None, seed: int = 0, device="cuda",
                quiet: bool = False) -> CodedTrainResult:
    """Sec. 6 end to end: concurrent multi-model coded TRAINING of real
    transformer LMs (``cfg``, :func:`tiny_config` by default) under the 7
    schemes of :func:`scheme_grid`, through ``VectorizedCodedTrainer``, on
    batches of ``CODED_BATCH`` sequences of ``seq_len`` tokens, on the
    ``CODED_TRACES`` of ``trace_library(n, jobs + 8, 1, seed)``.  Each run's
    coded steps are timed on the host clock (synchronized on the card); a
    run's step time is the median after its first, warm-up, step.  After
    its ge-bursty run, each scheme's coded step is also measured in
    isolation, as the bench measures its jitted step: job 1's coded batch
    with unit weights, ``step_timer(fn, CODED_REPS)`` -> ms a call (by
    default the median host-clock ms of ``CODED_REPS`` calls after one
    warm-up call).

    Gates: (1) M-SGC's simulated clock is below GC's on ``ge-bursty``; (2)
    M-SGC's isolated step time is below GC's — its normalized load is lower,
    so the coded view carries fewer sequences a step; (3) every training
    loss is finite.
    """
    dev = resolve_device(device)
    cfg = tiny_config() if cfg is None else cfg
    lib = {sc.name: sc for sc in trace_library(n=n, rounds=jobs + 8, num_traces=1, seed=seed)}
    out = CodedTrainResult()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def host_seconds(fn):
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        return res, time.perf_counter() - t0

    def host_step_ms(fn, reps):
        fn()
        return 1e3 * float(np.median([host_seconds(fn)[1] for _ in range(reps)]))

    step_timer = host_step_ms if step_timer is None else step_timer
    for label, name, kw in scheme_grid(n):
        for tr_name in CODED_TRACES:
            sc = lib[tr_name]
            sch = make_scheme(name, n, jobs, **kw)
            trainer = VectorizedCodedTrainer(
                scheme=sch, cfg=cfg, num_models=models, batch_size=CODED_BATCH, seq_len=seq_len,
                lr=lr, mu=MU, alpha=float(np.mean(sc.alpha)), seed=seed, device=dev)
            step, times = trainer._step, []

            def timed(*args, step=step, times=times):
                res, seconds = host_seconds(lambda: step(*args))
                times.append(seconds)
                return res

            trainer._step = timed
            clock = trainer.run(jobs, sc.delays[0])
            finals = [trainer.losses[m][-1] for m in range(models)]
            if not all(np.isfinite(trainer.losses[m]).all() for m in range(models)):
                raise AssertionError(f"{label} on {tr_name}: a loss is not finite")
            out.sim_clock[(tr_name, label)] = clock
            out.step_ms[(tr_name, label)] = 1e3 * float(np.median(times[1:] or times))
            out.final_loss[(tr_name, label)] = float(np.mean(finals))
            out.loads[label] = sch.normalized_load
            out.steps += len(times)
            if tr_name == "ge-bursty":
                coded = coded_slot_batch(trainer._job_batch(1), sch.chunk_slots(1),
                                         trainer.num_chunks)
                w1 = torch.ones((n, trainer.slots), dtype=torch.float32, device=dev)
                out.isolated_ms[label] = step_timer(
                    lambda: step(trainer.params[0], trainer.opt[0], coded, w1), CODED_REPS)
            if not quiet:
                print(f"codedtrain.{tr_name}.{label},{clock:.2f},sim clock "
                      f"(load={sch.normalized_load:.4f} T={sch.T} "
                      f"final_loss={np.mean(finals):.3f} "
                      f"step={out.step_ms[(tr_name, label)]:.2f} ms median of "
                      f"{len(times) - 1} after a warm-up)")
            del trainer
    out.ratio = out.isolated_ms["m-sgc"] / out.isolated_ms["gc"]
    if not quiet:
        for tr_name in CODED_TRACES:
            gain = 1 - out.sim_clock[(tr_name, "m-sgc")] / out.sim_clock[(tr_name, "gc")]
            print(f"codedtrain.{tr_name}.msgc_vs_gc_gain,{gain:.4f},"
                  "sim-clock gain (paper Table 1: 16%)")
        for label, ms in out.isolated_ms.items():
            print(f"codedtrain.step_ms.{label},{ms:.2f},isolated coded step")
        print(f"codedtrain.msgc_vs_gc_step_ratio,{out.ratio:.3f},"
              "measured step-time ratio (< 1: lower coded load wins)")
    if not out.sim_clock[("ge-bursty", "m-sgc")] < out.sim_clock[("ge-bursty", "gc")]:
        raise AssertionError("M-SGC must beat plain GC on the bursty trace end to end")
    if not out.ratio < 1.0:
        raise AssertionError(f"M-SGC measured step time regressed: {out.ratio:.3f}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=["sweep", "train", "multimodel"])
    ap.add_argument("--n", type=int, default=None,
                    help="workers (sweep: 64, train: 8, multimodel: 64)")
    ap.add_argument("--rounds", type=int, default=40, help="sweep: rounds a trace")
    ap.add_argument("--traces", type=int, default=4, help="sweep: traces a scenario")
    ap.add_argument("--jobs", type=int, default=None, help="train: 24, multimodel: 80")
    ap.add_argument("--models", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="train: full-width qwen2-0.5b instead of the tiny model")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    if args.what == "sweep":
        scenario_sweep(args.n or 64, args.rounds, args.traces, seed=args.seed,
                       device=args.device)
    elif args.what == "train":
        coded_train(args.n or 8, args.models, args.jobs or 24,
                    cfg=get_config(ARCH) if args.full else None,
                    seq_len=64 if args.full else 8, lr=1e-4 if args.full else 1e-3,
                    seed=args.seed, device=args.device)
    else:
        multimodel_training(args.jobs or 80, args.n or 64, args.models, args.seed,
                            device=args.device)


if __name__ == "__main__":
    main()
