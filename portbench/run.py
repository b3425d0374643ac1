"""Run one cell of the port's benchmark on the card and print one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``src/repro_torch``.  Exits with 1 and
prints no result where there is no card (or fewer than the cell asks for),
where the checkout lacks the program, where JAX or the JAX package was
loaded, or where a hook of the harness was not reached or a per-layer metric
the cell lists read nothing (``harness.Unread``).  The numbers compared come last on standard error and last in the
line, under ``compared``.
"""

import time

T0 = time.perf_counter()   # the set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: whole top-level module names the run may not load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def say(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def refuse(msg: str) -> None:
    say(f"no result: {msg}")
    sys.exit(1)


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), each compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    for path in (str(ROOT / "src"), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)
    from portbench import spec

    try:
        cell = spec.load_cell(args.workload)
    except (KeyError, FileNotFoundError) as e:
        refuse(f"no cell {args.workload!r} ({e})")
    import torch

    chips = {w["name"]: w["chips"] for w in spec.benchmark()["workloads"]}[args.workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        refuse(f"the cell needs {chips} CUDA device(s); "
               f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        refuse(f"the program is not in this checkout ({e})")
    from portbench import harness

    try:
        result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0, log=say)
    except harness.Unread as e:
        refuse(str(e))
    found = forbidden_modules()
    if found:
        refuse(f"loaded {', '.join(found)}")
    for name, row in result["compared"].items():
        say(f"compared {name} {row['value']!r} limit {row['limit']!r}")
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
