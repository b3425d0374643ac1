"""``determinism`` — the simulation core must be replayable.

Every bit-identity guarantee in the differential suites
(tests/test_lockstep.py, tests/test_determinism.py) assumes the
``core`` engine is a pure function of its seeds: no wall clock, no
global/unseeded RNG.  Clock reads and durations belong in ``dist`` /
``launch`` / ``benchmarks`` — and where ``launch`` measures durations
it must use a monotonic clock (``time.perf_counter``), never
``time.time``, which steps under NTP adjustment.

Checks, by scope bucket (config):

* under ``no_clock_under`` (core): any ``time.*`` clock read,
  ``datetime.now/utcnow/today``, ``np.random.default_rng()`` with no
  seed, legacy global-RNG calls (``np.random.<dist>``, ``np.random.seed``),
  and ``random``-module calls;
* under ``monotonic_only_under`` (launch): ``time.time()`` — durations
  must come from ``time.perf_counter()``.
"""

from __future__ import annotations

import ast

from ..astutil import dotted_name
from ..engine import Rule, Violation, register_rule

_CLOCK_CALLS = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.process_time",
}
_DATETIME_CALLS = {
    "datetime.now", "datetime.utcnow", "datetime.today",
    "datetime.datetime.now", "datetime.datetime.utcnow", "date.today",
}
_WALL_CLOCK = {"time.time", "time.time_ns"}


class DeterminismRule(Rule):
    id = "determinism"
    description = (
        "no wall clock or unseeded/global RNG in the simulation core; "
        "launch durations use monotonic clocks (time.perf_counter)"
    )

    def check_file(self, ctx):
        opts = ctx.options
        in_core = any(ctx.path.startswith(p)
                      for p in opts.get("no_clock_under", []))
        in_launch = any(ctx.path.startswith(p)
                        for p in opts.get("monotonic_only_under", []))
        out: list[Violation] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name is None:
                continue
            if in_core:
                out.extend(self._core_call(ctx, node, name))
            if in_launch and name in _WALL_CLOCK:
                out.append(Violation(
                    self.id, ctx.path, node.lineno, node.col_offset,
                    f"{name}() is not monotonic; measure durations with "
                    "time.perf_counter()",
                ))
        return out

    def _core_call(self, ctx, node: ast.Call, name: str):
        if name in _CLOCK_CALLS or name in _DATETIME_CALLS:
            yield Violation(
                self.id, ctx.path, node.lineno, node.col_offset,
                f"clock read {name}() in the simulation core breaks "
                "replay determinism",
            )
            return
        if name.endswith("default_rng") and not node.args and not node.keywords:
            yield Violation(
                self.id, ctx.path, node.lineno, node.col_offset,
                "default_rng() without a seed is entropy-seeded; pass an "
                "explicit seed sequence",
            )
            return
        if name.startswith("np.random.") or name.startswith("numpy.random."):
            tail = name.rsplit(".", 1)[1]
            if tail != "default_rng":
                yield Violation(
                    self.id, ctx.path, node.lineno, node.col_offset,
                    f"legacy global-RNG call {name}() shares mutable state "
                    "across the process; use a seeded default_rng stream",
                )
            return
        if name.startswith("random."):
            yield Violation(
                self.id, ctx.path, node.lineno, node.col_offset,
                f"stdlib {name}() uses the global Mersenne state; use a "
                "seeded numpy Generator",
            )


register_rule(DeterminismRule())
