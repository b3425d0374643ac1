"""Contract rules.  Importing this package registers every rule with
``repro_torch.analysis.engine.RULES``; each module is one contract and its
docstring is the authoritative statement of it."""

from __future__ import annotations

from . import (  # noqa: F401  (import-for-registration)
    backend_shim,
    blanket_except,
    deserialization,
    determinism,
    fused_contract,
    protocol,
    tracer_safety,
)
