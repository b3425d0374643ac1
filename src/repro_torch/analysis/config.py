"""Per-rule scope and knobs for the port.

Every rule carries its own ``files`` glob list (repo-root-relative) — the
discipline is absolute *within* a scope rather than diluted across the
tree.  Each scope maps the JAX package's (``repro.analysis.config``) one
for one onto ``src/repro_torch``:

* ``backend-shim`` / ``tracer-safety`` / ``fused-contract`` bind to
  ``core/kernel.py``, the one module whose code runs once per round on the
  device for every cell.  ``core/batch.py`` / ``core/straggler.py`` hold
  host-side numpy simulation too and legitimately call ``np.*``, so they
  are out of shim scope by design.
* ``determinism`` splits into the no-clock core bucket and the
  monotonic-only launch bucket.
* ``unsafe-deserialization`` bans pickle outright under ``checkpoint/``
  and restricts the wire under ``dist/``.
* ``protocol-exhaustiveness`` spans exactly the modules that touch the
  dict-message wire protocol.

``staged_functions`` names the kernel and gate entry points of a lockstep
round (the JAX package's staged functions; ``_wait_out`` is the port's
``_admit_partial_traced``, ``_wait_out_variants`` its numpy branch for a gate
that is not analytic), and ``traced_params`` the identifiers that carry
per-cell tensors through them.  Round indices, jobs and their validity are
host ints in the port, so they are not among them.  Extend both when adding
a kernel with new per-round surface.
"""

from __future__ import annotations

DEFAULT_CONFIG: dict = {
    "suppression-syntax": {
        # parse-check every python file any rule can see, plus the rest of
        # the port so a stray malformed allow comment is caught
        "files": ["src/repro_torch/**/*.py"],
    },
    "backend-shim": {
        "files": ["src/repro_torch/core/kernel.py"],
        # host-side setup that never runs per round
        "allow_functions": ["__init__", "fused_scalars"],
        "allow_calls": [],
    },
    "tracer-safety": {
        "files": ["src/repro_torch/core/kernel.py"],
        "staged_functions": [
            "step",
            "admit_partial",
            "admit_all",
            "_wait_out",
            "_wait_out_variants",
            "_member_ok",
            "_pending",
            "_valid",
            "_mark_done",
        ],
        "traced_params": [
            "state",
            "stragglers",
            "candidate",
            "cost",
            "cand",
            "any_cand",
            "row",
            "pending",
            "can",
            "bufs",
            "alive",
            "gs",
            "tails",
            "mok",
            "resolved",
        ],
    },
    "fused-contract": {
        "files": ["src/repro_torch/core/kernel.py"],
        "host_functions": [
            "__init__",
            "bind_fused",
            "fused_scalars",
            "init_state",
        ],
    },
    "determinism": {
        "files": [
            "src/repro_torch/core/*.py",
            "src/repro_torch/launch/*.py",
        ],
        "no_clock_under": ["src/repro_torch/core/"],
        "monotonic_only_under": ["src/repro_torch/launch/"],
    },
    "unsafe-deserialization": {
        "files": [
            "src/repro_torch/checkpoint/*.py",
            "src/repro_torch/dist/*.py",
        ],
        "ban_under": ["src/repro_torch/checkpoint/"],
        "wire_under": ["src/repro_torch/dist/"],
    },
    "blanket-except": {
        "files": [
            "src/repro_torch/core/*.py",
            "src/repro_torch/dist/*.py",
        ],
    },
    "protocol-exhaustiveness": {
        "files": [
            "src/repro_torch/dist/master.py",
            "src/repro_torch/dist/worker.py",
            "src/repro_torch/dist/supervisor.py",
            "src/repro_torch/dist/transport.py",
            "src/repro_torch/dist/net.py",
        ],
    },
}
