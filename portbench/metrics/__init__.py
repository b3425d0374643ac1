"""The per-layer metrics' readers: ``<metric>.py`` beside this file, each with
``read(ctx) -> float | None``, found by the metric's name in
``BENCHMARK.json``.  A reader that finds nothing to read returns None; the
harness then reports no result for a run of a cell that lists the metric
(``harness.Unread``).

``ctx`` (a namespace the harness fills) holds ``cell``, ``model`` (the configuration's
sizes), ``mix``, ``seqs`` (sequences a coded step computes), ``window``
(``wall_s``, ``jobs``, ``blocks`` and ``step_s``, the harness's spans around
the coded step's calls), ``trace`` (``trace.Trace`` of the traced block) and
``launches`` (``jobs`` of the traced block, ``per_job`` kernel launches by
the port's counters, ``formula`` their count from the configuration).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def read(name: str, ctx):
    path = HERE / f"{name}.py"
    module = f"portbench.metrics.{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(module, path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    return reader.read(ctx)


def kernel_s_per_step(ctx, wrapper: str, families: tuple[str, ...]) -> float | None:
    """Device seconds a step of the launches of one kernel wrapper of the
    port (``wrapper``, its counter's name) whose kernels are ``families``
    (name patterns, one kernel each a call): each kernel's mean over the
    launches the profiler recorded, times the calls a step.  None where the
    counters do not show the formula's calls (the step took another path)
    or the profiler recorded none of a kernel."""
    calls = ctx.launches["per_job"][wrapper]
    if not calls or calls != ctx.launches["formula"][wrapper]:
        return None
    means = ctx.trace.mean_time({f: f for f in families})
    if len(means) != len(families):
        return None
    return calls * sum(means.values())


def range_s_per_step(ctx, names: tuple[str, ...]) -> float | None:
    """Device seconds a step attributed to the profiler ranges ``names``."""
    found = [ctx.trace.ranges[n] for n in names if n in ctx.trace.ranges]
    return sum(found) / ctx.launches["jobs"] if found else None
