"""One run of a cell: set-up, the measured window, the traced block and the
check that decides ``correct``.

The program under test is the port's multi-model coded trainer,
``repro_torch.train.VectorizedCodedTrainer``.  Its ``run`` is the paper's
loop: each round the straggler gate on the round's delays, the scheme's
step, and each decoded job one coded step (the weighted coded loss, forward
and backward with each layer body rematerialised, AdamW in place).  The
harness builds one trainer for the cell, loads the benchmark's weights into
it, hands it each job's batch (``feed.job_batch``) and drives ``run`` over
blocks of jobs, a fresh scheme and fresh delays a block.

* Set-up: the trainer, the weights, and block 0, which warms every shape
  the window uses; its first jobs are the ones checked.
* Window: blocks 1, 2, ... until ``seconds`` have passed, ending with the
  block that crosses it.
* ``trace``: the window's steps are timed by spans of the harness's own, and
  one more block runs under the profiler.
* Check: after the window, the trainer freed, the reference runs the first
  jobs again (``reference/``) and the numbers are held to the cell's limits.
"""

from __future__ import annotations

import contextlib
import gc
import math
import time
from types import SimpleNamespace

import torch

from . import feed, flops
from .reference import compare
from .reference.train import fp8_matmul, reference_run
from .weights import DTYPES, load_into, make_weights, tree_paths

CHECKED_JOBS = 3
FAULTS = ("frozen_state", "half_batch")
#: profiler ranges the metrics read: the harness's own and the program's
RANGES = {"portbench.step", "portbench.adamw", "ssd.pad", "ssd.cum", "ssd.contrib",
          "ssd.recurrence", "ssd.chunk_scan"}
#: the port's kernel wrappers, each of which counts its launches
KERNELS = {
    "flash_attention": "repro_torch.kernels.flash_attention.flash_attention",
    "flash_attention_bwd": "repro_torch.kernels.flash_attention.flash_attention",
    "rmsnorm": "repro_torch.kernels.rmsnorm.rmsnorm",
    "rmsnorm_bwd": "repro_torch.kernels.rmsnorm.rmsnorm",
    "ssd_chunk_scan": "repro_torch.kernels.ssd_scan.ssd_scan",
    "ssd_chunk_scan_bwd": "repro_torch.kernels.ssd_scan.ssd_scan",
    "ssd_intra_chunk": "repro_torch.kernels.ssd_scan.ssd_scan",
    "coded_combine": "repro_torch.kernels.gc_coding.gc_coding",
}


class Unread(RuntimeError):
    """A hook of the harness that the program never reached, or a per-layer
    metric the cell lists that read nothing: the run reports no result, so
    that a change to the program's call path cannot drop a number silently."""


def launch_counts() -> dict[str, int]:
    import importlib

    return {k: getattr(importlib.import_module(mod), k).launches for k, mod in KERNELS.items()}


def chunk_ids(coded: dict, batch: dict, num_chunks: int) -> torch.Tensor:
    """(n, slots) id of the job's chunk each slot of the coded view holds,
    -1 where it holds none: matched on the labels, then every tensor of the
    chunk compared whole."""
    labels = batch["labels"].reshape(num_chunks, -1)
    view = coded["labels"]
    n, slots = view.shape[:2]
    flat = view.reshape(n * slots, -1)
    if flat.shape[1] != labels.shape[1]:
        return torch.full((n, slots), -1, device=labels.device)
    eq = (flat[:, None, :] == labels[None, :, :]).all(-1)
    ids = torch.where(eq.sum(1) == 1, eq.int().argmax(1), -1)
    for key, leaf in batch.items():
        chunks = leaf.reshape(num_chunks, -1)
        got = coded[key].reshape(n * slots, -1)
        same = (got == chunks[ids.clamp(min=0)]).all(-1)
        ids = torch.where(same, ids, -1)
    return ids.reshape(n, slots)


def decode_gap(w: torch.Tensor, ids: torch.Tensor, num_chunks: int) -> float:
    """max over the job's chunks of |its total decode weight - 1|; a weight
    on a slot that holds no chunk of the job counts whole."""
    w = w.to(torch.float64).reshape(-1)
    ids = ids.reshape(-1)
    known = ids >= 0
    totals = torch.zeros(num_chunks, dtype=torch.float64, device=w.device)
    totals.index_add_(0, ids[known], w[known])
    stray = w[~known].abs().max().item() if (~known).any() else 0.0
    return max((totals - 1).abs().max().item(), stray)


class Bench:
    """The cell's trainer and what the harness does around it."""

    def __init__(self, model: dict, mix: dict, seed: int, device, *, fault: str | None = None):
        from repro_torch.core import make_scheme
        from repro_torch.models.config import ModelConfig
        from repro_torch.train import VectorizedCodedTrainer

        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; faults: {FAULTS}")
        self.model, self.mix, self.seed, self.device, self.fault = model, mix, seed, device, fault
        self.on_card = torch.device(device).type == "cuda"
        self.dtype = DTYPES[model["dtype"]]
        self.cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                                  for k, v in model.items()})
        self._make_scheme = lambda: make_scheme(mix["scheme"], mix["n"], mix["block_jobs"],
                                                **mix["scheme_params"])
        self.trainer = VectorizedCodedTrainer(
            scheme=self._make_scheme(), cfg=self.cfg, num_models=mix["models"],
            batch_size=mix["job_batch"], seq_len=mix["seq_len"], lr=mix["lr"], mu=mix["mu"],
            alpha=mix["alpha"], seed=0, device=device)
        # the benchmark's weights in place of the program's own draw
        for m, params in enumerate(self.trainer.params):
            load_into(params, make_weights(model, seed, m, device))
        tr = self.trainer
        self.seqs = tr.scheme.n * tr.slots * (mix["job_batch"] // tr.num_chunks)
        self._program_step = tr._step
        tr._step = self._step
        tr._apply = self._apply
        tr._job_batch = self._batch
        self.block = 0
        self.job = None
        self.last_batch = None
        self.spans = False          # time each step (trace runs)
        self.step_s = 0.0
        self.steps = 0              # calls of the coded step through the hook
        self.readings: dict | None = None   # the checked jobs' readings (block 0)

    # -- the hooks around the program's calls -------------------------------
    def _batch(self, job: int) -> dict:
        self.last_batch = feed.job_batch(self.mix, self.model, self.seed, self.block, job,
                                         self.device, self.dtype)
        return self.last_batch

    def _step(self, params, opt, coded, w):
        nc = self.trainer.num_chunks
        self.steps += 1
        if self.fault == "half_batch":   # the first half of the chunks, each weighted twice
            w = w * 2 * (chunk_ids(coded, self.last_batch, nc) < nc // 2).to(w.dtype)
        if self.readings is not None and self.job is not None and self.job <= CHECKED_JOBS:
            ids = chunk_ids(coded, self.last_batch, nc)
            self.readings["decode_gaps"].append(decode_gap(w, ids, nc))
        if self.fault == "frozen_state":
            return self._frozen(params, opt, coded, w)
        if not self.spans:
            return self._program_step(params, opt, coded, w)
        t0 = time.perf_counter()
        with _range("portbench.step"):
            out = self._program_step(params, opt, coded, w)
        if self.on_card:
            torch.cuda.synchronize()
        self.step_s += time.perf_counter() - t0
        return out

    def _frozen(self, params, opt, coded, w):
        """The fault of a step that returns its state unchanged: the coded
        loss, and neither gradient nor update."""
        from repro_torch.train.coded import coded_loss

        with torch.no_grad():
            loss = coded_loss(params, self.cfg, coded, w, self.trainer.num_chunks)
        return params, opt, {"loss": loss}

    def _apply(self, jd):
        self.job = jd.job
        type(self.trainer)._apply(self.trainer, jd)
        if self.readings is not None and jd.job <= CHECKED_JOBS:
            self._read_job(jd.job)

    # -- the checked jobs' readings (block 0) -------------------------------
    def _read_job(self, job: int) -> None:
        from .reference.train import leaf_norms

        tr, models = self.trainer, self.mix["models"]
        m = (job - 1) % models
        self.readings["losses"][job] = tr.losses[m][-1]
        if job <= models:   # the model's first step: its gradient from the first moment
            b1 = self.mix["adam"]["b1"]
            self.readings["grad_norms"][m] = {
                p: v / (1 - b1) for p, v in leaf_norms(tree_paths(tr.opt[m].m)).items()}
        if job == CHECKED_JOBS:
            for k in range(min(models, CHECKED_JOBS)):
                start = make_weights(self.model, self.seed, k, self.device)
                self.readings["change_norms"][k] = leaf_norms(
                    (p, leaf.float() - start[p].float()) for p, leaf in tree_paths(tr.params[k]))
                del start

    # -- blocks -------------------------------------------------------------
    def run_block(self, block: int) -> int:
        """Block ``block``: a fresh scheme over ``block_jobs`` jobs and their
        delays, through the trainer's ``run``.  Returns the jobs decoded."""
        tr = self.trainer
        self.block = block
        tr.scheme = self._make_scheme()
        tr.job_done_time = {}
        jobs = self.mix["block_jobs"]
        steps = self.steps
        tr.run(jobs, feed.block_delays(self.mix, self.seed, block, jobs + tr.scheme.T + 1))
        done = len(tr.job_done_time)
        if self.steps - steps != done:
            raise Unread(f"block {block}: {done} jobs decoded, {self.steps - steps} coded steps "
                         f"through the harness's hook on the trainer's _step")
        return done

    def setup_block(self) -> None:
        """Block 0: warms every shape the window runs, and reads the checked
        jobs."""
        self.readings = {"losses": {}, "grad_norms": {}, "change_norms": {}, "decode_gaps": []}
        self.run_block(0)
        readings, self.readings = self.readings, None
        want = range(1, CHECKED_JOBS + 1)
        if (sorted(readings["losses"]) != list(want) or len(readings["decode_gaps"]) != len(want)
                or len(readings["change_norms"]) != min(self.mix["models"], CHECKED_JOBS)):
            raise Unread(f"block 0 read jobs {sorted(readings['losses'])} and "
                         f"{len(readings['decode_gaps'])} decodes, not jobs 1-{CHECKED_JOBS}: "
                         f"the trainer's _apply or _step was not reached through the hooks")
        self.checked = readings

    def losses_finite(self) -> int:
        """Steps whose loss was not finite, over all the trainer's steps."""
        return sum(not math.isfinite(x) for xs in self.trainer.losses.values() for x in xs)

    def free(self) -> None:
        self.trainer = self._program_step = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


@contextlib.contextmanager
def _range(name: str):
    if torch.autograd._profiler_enabled():
        with torch.profiler.record_function(name):
            yield
    else:
        yield


@contextlib.contextmanager
def adamw_range(steps: int):
    """A profiler range around each ``adamw_update`` call of the coded step:
    the step's module looks the function up when it runs, so the range goes
    in there for the traced block and comes out after it.  Raises ``Unread``
    unless the block's ``steps()`` coded steps each called it once."""
    from repro_torch.train import coded

    program, calls = coded.adamw_update, []

    def ranged(*args, **kwargs):
        calls.append(1)
        with _range("portbench.adamw"):
            return program(*args, **kwargs)

    coded.adamw_update = ranged
    try:
        yield
    finally:
        coded.adamw_update = program
    if len(calls) != steps():
        raise Unread(f"train.coded.adamw_update was called {len(calls)} times in "
                     f"{steps()} coded steps: the step reaches its optimizer another way, "
                     f"and the range adamw_ms_per_step reads is not around it")


def reference_readings(model: dict, mix: dict, seed: int, device, *, control: bool = False,
                       rows: int = 8) -> dict:
    """The reference's (or with ``control`` the fp8 control's) readings of the
    checked jobs, from the same weights and batches as the program's."""
    dtype = DTYPES[model["dtype"]]
    return reference_run(
        model, mix, lambda m: make_weights(model, seed, m, device),
        lambda j: feed.job_batch(mix, model, seed, 0, j, device, dtype),
        jobs=CHECKED_JOBS, mm=fp8_matmul if control else torch.matmul, rows=rows)


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float, *,
        fault: str | None = None, log=print) -> dict:
    """One run of ``cell`` (``spec.Cell``); returns the result line's dict.
    ``t0`` is the process's start on ``time.perf_counter``'s clock.  On a
    CPU ``device`` (a rehearsal) nothing is reported under a device metric's
    name."""
    on_card = torch.device(device).type == "cuda"
    model, mix = cell.config["model"], cell.mix
    built = _build_seconds() if on_card else 0.0
    bench = Bench(model, mix, seed, device, fault=fault)
    bench.setup_block()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s (kernel build {built:.3f} s); {bench.seqs} sequences "
        f"a coded step, {mix['block_jobs']} jobs a block")

    bench.spans = trace
    start, jobs, blocks = time.perf_counter(), 0, 0
    while True:
        blocks += 1
        jobs += bench.run_block(blocks)
        if on_card:
            torch.cuda.synchronize()
        if time.perf_counter() - start >= seconds:
            break
    wall = time.perf_counter() - start
    window = {"wall_s": wall, "jobs": jobs, "blocks": blocks, "step_s": bench.step_s}
    log(f"window {wall:.3f} s: {blocks} blocks, {jobs} jobs")

    traced = launches = None
    if trace:
        traced, launches = _traced_block(bench, blocks + 1, on_card, log)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    failed = bench.losses_finite()
    checked, seqs = bench.checked, bench.seqs
    bench.free()
    del bench

    found = compare.numbers(checked, reference_readings(model, mix, seed, device))
    correct, table = compare.judge(found, cell.limits)
    ctx = SimpleNamespace(cell=cell, model=model, mix=mix, window=window, trace=traced,
                          launches=launches, seqs=seqs)
    if not on_card:     # a rehearsal: no number under a metric of the card's
        metrics = {}
    elif trace:
        metrics = _per_layer(cell, ctx, log)
    else:
        metrics = _end_to_end(cell, ctx, setup_s, peak)
    result = {"correct": correct, "attempted": jobs, "failed": failed, "metrics": metrics}
    if on_card:
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                            "count": 1, "memory_peak_bytes": peak}
        if traced is not None:
            result["device"].update(busy_s=traced.busy_s, window_s=traced.window_s)
            from .trace import breakdown

            result["breakdown"] = breakdown(traced)
    result["compared"] = table
    return result


def _build_seconds() -> float:
    """Build (first run of a checkout: nvcc) or load the port's kernels."""
    from repro_torch.kernels import _build

    _build.library()
    return _build.build().seconds


def _traced_block(bench: Bench, block: int, on_card: bool, log):
    from .trace import profile_block

    before = launch_counts()
    if not on_card:
        bench.run_block(block)
        return None, None
    jobs = []
    with adamw_range(lambda: sum(jobs)):
        traced = profile_block(lambda: jobs.append(bench.run_block(block)), RANGES)
    after = launch_counts()
    per_job = {k: (after[k] - before[k]) / jobs[0] for k in after}
    want = flops.launches_per_step(bench.model)
    log(f"traced block: {jobs[0]} jobs, {traced.activities} device activities, busy "
        f"{traced.busy_s:.6f} s of {traced.window_s:.6f} s, {traced.unattributed} with no "
        f"runtime call recorded; the card (step_mfu's peak is its 700 W rate): {card()}")
    for k, n in per_job.items():
        log(f"launches {k}: {n:g} a step (formula {want[k]})"
            + ("" if n == want[k] else " MISMATCH"))
    return traced, {"jobs": jobs[0], "per_job": per_job, "formula": want}


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e})"
    return out.stdout.strip() or f"unknown ({out.stderr.strip()})"


def _end_to_end(cell, ctx, setup_s, peak) -> dict:
    values = {
        "trained_tokens_per_s": ctx.window["jobs"] * feed.tokens_per_job(ctx.mix)
        / ctx.window["wall_s"],
        "setup_s": setup_s,
        "peak_mem_gib": None if peak is None else peak / 2 ** 30,
    }
    out = {}
    for m in cell.end_to_end:
        if values.get(m["name"]) is not None:
            out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out


def _per_layer(cell, ctx, log) -> dict:
    """The cell's per-layer metrics; raises ``Unread`` where one that
    ``BENCHMARK.json`` lists for the cell read nothing."""
    from .metrics import read

    out, unread = {}, []
    for m in cell.per_layer:
        value = read(m["name"], ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            unread.append(m["name"])
    if unread:
        raise Unread(f"{', '.join(unread)}: nothing to read in {cell.name}, which lists them "
                     f"(a span, range or kernel the reader wants did not run, or the launch "
                     f"counters differ from the formula: see the lines above)")
    return out
