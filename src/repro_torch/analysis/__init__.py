"""repro_torch.analysis — the port's contract linter.

Port of ``src/repro/analysis``: AST-based static analysis over
``src/repro_torch`` that enforces the invariants the test suites assume but
cannot economically cover — kernel bodies that stay on the device and never
read a tensor back to the host, the grid-fusion hooks kept closed,
determinism in the simulation core, pickle-free checkpoints, a
restricted-unpickler-only wire, concrete exception handling, and a balanced
send/handle wire protocol.

Run it as ``python -m repro_torch.analysis`` (see ``--help``; ``--strict``
also fails on stale baseline entries and unused suppressions).  Suppressions
take the JAX package's syntax, ``# repro: allow[rule-id]: reason``.
"""

from __future__ import annotations

from . import rules  # noqa: F401  (import-for-registration)
from .config import DEFAULT_CONFIG
from .engine import (
    RULES,
    FileContext,
    ProjectContext,
    Report,
    Rule,
    Suppression,
    Violation,
    baseline_payload,
    load_baseline,
    register_rule,
    run_analysis,
    run_on_sources,
)

__all__ = [
    "DEFAULT_CONFIG",
    "FileContext",
    "ProjectContext",
    "Report",
    "Rule",
    "RULES",
    "Suppression",
    "Violation",
    "baseline_payload",
    "load_baseline",
    "register_rule",
    "run_analysis",
    "run_on_sources",
]
