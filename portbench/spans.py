"""The program's own spans over a traced block (``repro_torch.tracing``): the
coded step's phases, the model span each device activity belongs to, and the
card's idle time by span.

    python3 -m portbench.spans --workload <cell> --seed <n>

From the root of a checkout, on the card.  Sets the cell up as ``run.py``
does and, as a ``--trace 1`` run does, runs one block with the program's
spans recorded in memory (the master loop's host time) and one more under
the profiler; prints the tables on standard error and one JSON line on
stdout: the card, the busy time a step, and the numbers ``readings`` gives.
That line is no result of the benchmark, whose harness does not read the
program's spans.

The pass over a profiled block (``program_pass``) puts each device activity
down to the runtime call that launched it, and so to a phase of the coded
step: *forward* inside ``step.forward``; in ``step.backward``, *recompute*
under a ``model.*`` span on the launching thread (a rematerialised layer run
again on autograd's engine thread) and *backward* otherwise, on any thread;
*optimizer* inside ``step.optimizer``; *outside* else, and for an activity of
no runtime call.  Its model span is the innermost ``model.*`` span on the
launching thread; a backward activity takes that of the forward op whose
autograd node it runs, which the profiler names by (forward thread,
sequence number) on the node's host event.  Its train span is the innermost
``train.*`` span open on any thread.  Idle time: the window's gaps cut to
each span's intervals (``span_idle``), and each gap put down whole to the
innermost program span open at its start, on any thread (``idle_in``).
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field

from portbench.trace import SPINS, WINDOW, innermost, union_length

#: the program's span names start so
PROGRAM = ("train.", "step.", "model.")
PHASES = ("forward", "recompute", "backward", "optimizer", "outside")
#: the host event around a backward node's work; its sequence number and
#: forward thread are those of the forward op that made the node
BACKWARD_NODE = "autograd::engine::evaluate_function: "
#: the model spans whose device time ``readings`` sets against the recompute
LAYERS = ("model.attention", "model.mlp", "model.ssm")


@dataclass
class Program:
    """A profiled block by the program's spans.  Times in seconds."""

    window_s: float
    busy_s: float
    phases: dict = field(default_factory=dict)      # phase -> device seconds
    by_model: dict = field(default_factory=dict)    # (model span or "", phase) -> seconds
    by_train: dict = field(default_factory=dict)    # (train span or "", phase) -> seconds
    span_idle: dict = field(default_factory=dict)   # program span -> idle seconds inside it
    idle_in: dict = field(default_factory=dict)     # innermost program span -> idle seconds
    outside: int = 0                                # device activities of no phase


def split_events(events) -> tuple[list, list, list]:
    """(device, cpu, ops) of the profiler's events: ``trace.reduce``'s
    device activities (spin kernels and the device side of host ranges left
    out) and host events, and (name, start_us, end_us, thread, sequence_nr,
    forward thread) of each host event that carries a sequence number."""
    from torch.autograd import DeviceType

    cpu, device, ops = [], [], []
    for e in events:
        if e.device_type == DeviceType.CPU:
            cpu.append((e.name, e.time_range.start, e.time_range.end, e.thread, e.id))
            if e.sequence_nr >= 0:
                ops.append((e.name, e.time_range.start, e.time_range.end, e.thread,
                            e.sequence_nr, e.fwd_thread))
    annotations = {name for name, *_ in cpu if not name.startswith(("aten::", "cu"))}
    for e in events:
        if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name \
                and e.name not in annotations:
            device.append((e.name, e.time_range.start, e.time_range.end, e.id))
    return device, cpu, ops


def _lookup(events, times: list) -> list:
    """``innermost`` at times in any order, in their order."""
    order = sorted(range(len(times)), key=times.__getitem__)
    out = [None] * len(times)
    for i, found in zip(order, innermost(events, [times[i] for i in order])):
        out[i] = found
    return out


def _per_thread(events_by_thread: dict, queries: list) -> list:
    """For each (time, thread) of ``queries``, the innermost event of
    ``events_by_thread[thread]`` that holds the time, or None."""
    by_thread = defaultdict(list)
    for i, (_, thread) in enumerate(queries):
        by_thread[thread].append(i)
    out = [None] * len(queries)
    for thread, idx in by_thread.items():
        found = _lookup(events_by_thread.get(thread, []), [queries[i][0] for i in idx])
        for i, f in zip(idx, found):
            out[i] = f
    return out


def _overlap(intervals, gaps) -> float:
    """Length of the union of ``intervals`` that ``gaps`` (sorted, disjoint)
    cover."""
    starts = [s for s, _ in gaps]
    total, cur = 0.0, None
    for s, e in sorted(intervals) + [(float("inf"), float("inf"))]:
        if cur is not None and s <= cur[1]:
            cur[1] = max(cur[1], e)
            continue
        if cur is not None:     # a piece of the union: the gaps that reach into it
            i = max(bisect.bisect_right(starts, cur[0]) - 1, 0)
            while i < len(gaps) and gaps[i][0] < cur[1]:
                total += max(0.0, min(cur[1], gaps[i][1]) - max(cur[0], gaps[i][0]))
                i += 1
        cur = [s, e]
    return total


def program_pass(device, cpu, ops) -> Program | None:
    """The block by the program's spans (module docstring), or None where
    the trace holds none of them.  ``device`` and ``cpu`` as ``trace.reduce``
    takes them, ``ops`` as ``split_events`` gives them."""
    spans = [(n, s, e, th) for n, s, e, th, _ in cpu if n.startswith(PROGRAM)]
    if not spans:
        return None
    win = [(s, e) for name, s, e, _, _ in cpu if name == WINDOW]
    if not win:
        raise ValueError("the trace holds no window range")
    # the window's activities, busy time and gaps, as trace.reduce takes them
    w0, w1 = win[0]
    work = [(n, max(s, w0), min(e, w1), c) for n, s, e, c in device if e > w0 and s < w1]
    busy_us, gaps = union_length((s, e) for _, s, e, _ in work)
    if work:
        first, last = min(s for _, s, _, _ in work), max(e for _, _, e, _ in work)
        gaps = [(w0, first)] + gaps + [(last, w1)]
    gaps = sorted((s, e) for s, e in gaps if e > s)

    steps = [(n, s, e) for n, s, e, _ in spans if n.startswith("step.")]
    trains = [(n, s, e) for n, s, e, _ in spans if n.startswith("train.")]
    models, nodes, made = defaultdict(list), defaultdict(list), {}
    for n, s, e, th in spans:
        if n.startswith("model."):
            models[th].append((n, s, e))
    for name, s, e, th, seq, fwd_thread in ops:
        if name.startswith(BACKWARD_NODE):
            nodes[th].append(((fwd_thread, seq), s, e))
        elif not fwd_thread:        # a forward op; the last of a key made the node
            made[(th, seq)] = max(s, made.get((th, seq), s))
    calls = {corr: (s, th) for n, s, _, th, corr in cpu if n.startswith("cu")}
    launched = [calls[c] for _, _, _, c in work if c in calls]
    times = [s for s, _ in launched]
    step_at, train_at = _lookup(steps, times), _lookup(trains, times)
    model_at, node_at = _per_thread(models, launched), _per_thread(nodes, launched)
    phase_at = [{"step.forward": "forward", "step.optimizer": "optimizer",
                 "step.backward": "recompute" if model else "backward"}.get(step, "outside")
                for step, model in zip(step_at, model_at)]
    keys = sorted({k for k, p in zip(node_at, phase_at) if p == "backward" and k in made})
    forward_model = dict(zip(keys, _per_thread(models, [(made[k], k[0]) for k in keys])))
    phases, by_model, by_train = defaultdict(float), defaultdict(float), defaultdict(float)
    outside, i = 0, 0
    for _, s, e, c in work:
        secs = (e - s) / 1e6
        if c in calls:
            phase, train = phase_at[i], train_at[i] or ""
            model = forward_model.get(node_at[i]) if phase == "backward" else model_at[i]
            model, i = model or "", i + 1
        else:
            phase, model, train = "outside", "", ""
        outside += phase == "outside"
        phases[phase] += secs
        by_model[(model, phase)] += secs
        by_train[(train, phase)] += secs
    intervals = defaultdict(list)
    for n, s, e, _ in spans:
        intervals[n].append((s, e))
    span_idle = {n: _overlap(iv, gaps) / 1e6 for n, iv in intervals.items()}
    idle_in: dict = defaultdict(float)
    for (s, e), n in zip(gaps, innermost([(n, s, e) for n, s, e, _ in spans],
                                         [s for s, _ in gaps])):
        idle_in[n or ""] += (e - s) / 1e6
    return Program(window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6, phases=dict(phases),
                   by_model=dict(by_model), by_train=dict(by_train), span_idle=span_idle,
                   idle_in=dict(idle_in), outside=outside)


def master_ms_per_job(spans) -> float | None:
    """Host milliseconds a decoded job in the master loop, from the spans
    ``tracing.recording()`` kept: the rounds (``train.round``) less each
    job's batch (``train.batch``) and coded step (``train.step``), over the
    decoded jobs (``train.job``); None where no round or job was recorded."""
    total = {"train.round": 0, "train.batch": 0, "train.step": 0}
    jobs = 0
    for s in spans:
        if s.name in total:
            total[s.name] += s.end_ns - s.start_ns
        jobs += s.name == "train.job"
    if not jobs or not total["train.round"]:
        return None
    return (total["train.round"] - total["train.batch"] - total["train.step"]) / jobs / 1e6


def readings(prog: Program, steps: int) -> dict:
    """Milliseconds a step: each phase's device time, ``model.head``'s over
    every phase, the idle time inside ``step.optimizer``, the busy time, the
    forward's device time under the layers' spans (``LAYERS``), which the
    recompute should come close to under full remat; and the count of
    activities outside the phases."""
    per_step = 1e3 / steps
    out = {f"{p}_ms_per_step": prog.phases.get(p, 0.0) * per_step for p in PHASES}
    out["head_ms_per_step"] = sum(v for (m, _), v in prog.by_model.items()
                                  if m == "model.head") * per_step
    out["optimizer_idle_ms_per_step"] = prog.span_idle.get("step.optimizer", 0.0) * per_step
    out["busy_ms_per_step"] = prog.busy_s * per_step
    out["layers_forward_ms_per_step"] = sum(prog.by_model.get((m, "forward"), 0.0)
                                            for m in LAYERS) * per_step
    out["outside_activities"] = prog.outside
    return out


def tables(prog: Program, steps: int) -> list[str]:
    """Device ms a step by span and phase (``model.*`` spans, then
    ``train.*``; "-" for none), and idle ms a step by span: inside each
    span's intervals, and put down to the innermost span at each gap's
    start."""
    out = ["device ms a step by span and phase: span | " + " | ".join(PHASES) + " | all"]
    for table in (prog.by_model, prog.by_train):
        for name in sorted({n for n, _ in table}):
            row = [table.get((name, p), 0.0) * 1e3 / steps for p in PHASES]
            out.append(f"  {name or '-'} | " + " | ".join(f"{v:.3f}" for v in row)
                       + f" | {sum(row):.3f}")
    out.append("idle ms a step by program span: span | inside its intervals | innermost")
    for name in sorted(set(prog.span_idle) | set(prog.idle_in)):
        out.append(f"  {name or '-'} | {prog.span_idle.get(name, 0.0) * 1e3 / steps:.3f} | "
                   f"{prog.idle_in.get(name, 0.0) * 1e3 / steps:.3f}")
    return out


def profiled_events(fn) -> list:
    """The profiler's events of ``fn()`` in the ``WINDOW`` range, between
    spin kernels as ``trace.profile_block`` runs it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for lead in range(2 * SPINS):
            torch.cuda._sleep(1000)
            if lead == SPINS - 1:
                time.sleep(0.05)
        torch.cuda.synchronize()
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
        for _ in range(SPINS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    return list(prof.events())


def main() -> None:
    import argparse
    import json
    import sys
    from pathlib import Path

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args()
    src = str(Path(__file__).resolve().parents[1] / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch

    from portbench import harness, spec
    from repro_torch import tracing

    def say(msg: str) -> None:
        print(f"[spans] {msg}", file=sys.stderr, flush=True)

    cell = spec.load_cell(args.workload)
    bench = harness.Bench(cell.config["model"], cell.mix, args.seed, "cuda")
    bench.setup_block()
    torch.cuda.synchronize()
    # as a --trace 1 run has them: each coded step ended by a synchronize (so
    # that train.loss_read does not wait for the device), and the optimizer's
    # range in the profiled block
    bench.spans = True
    with tracing.recording() as spans:
        recorded = bench.run_block(1)
        torch.cuda.synchronize()
    jobs = []
    with harness.adamw_range(lambda: sum(jobs)):
        events = profiled_events(lambda: jobs.append(bench.run_block(2)))
    prog = program_pass(*split_events(events))
    if prog is None:
        say("the trace holds none of the program's spans")
        sys.exit(1)
    for line in tables(prog, jobs[0]):
        say(line)
    line = {"cell": cell.name, "seed": args.seed, "card": harness.card(),
            "recorded_jobs": recorded, "spans_per_job": len(spans) / recorded,
            "master_ms_per_job": master_ms_per_job(spans), "traced_jobs": jobs[0],
            **readings(prog, jobs[0])}
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
