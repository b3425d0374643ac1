"""CLI for the port's contract linter: ``python -m repro_torch.analysis``.

Exit codes: 0 clean, 1 findings (or, with ``--strict``, stale baseline
entries / unused suppressions), 2 usage error.  ``--json`` emits the
machine-readable report (the JAX package's schema);
``--update-baseline`` rewrites the checked-in baseline to absorb the
current findings — reviewable churn, never automatic.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .config import DEFAULT_CONFIG
from .engine import RULES, baseline_payload, run_analysis

DEFAULT_BASELINE = "src/repro_torch/analysis/baseline.json"


def _find_root(start: Path) -> Path:
    """Nearest ancestor containing src/repro_torch — lets the CLI run from
    anywhere inside the repo."""
    cur = start.resolve()
    for cand in (cur, *cur.parents):
        if (cand / "src" / "repro_torch").is_dir():
            return cand
    return cur


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST contract linter for the PyTorch/CUDA port",
    )
    parser.add_argument(
        "--root", type=Path, default=None,
        help="repo root (default: nearest ancestor with src/repro_torch)",
    )
    parser.add_argument(
        "--baseline", type=Path, default=None,
        help=f"baseline file (default: <root>/{DEFAULT_BASELINE})",
    )
    parser.add_argument(
        "--json", action="store_true", help="emit the JSON report",
    )
    parser.add_argument(
        "--out", type=Path, default=None,
        help="write the JSON report to this path as well",
    )
    parser.add_argument(
        "--strict", action="store_true",
        help="also fail on stale baseline entries and unused suppressions",
    )
    parser.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite the baseline to absorb current findings",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit",
    )
    try:
        args = parser.parse_args(argv)
    except SystemExit as exc:
        return 0 if exc.code == 0 else 2

    if args.list_rules:
        width = max(len(r) for r in RULES)
        for rule_id in sorted(RULES):
            print(f"{rule_id:<{width}}  {RULES[rule_id].description}")
        return 0

    root = args.root.resolve() if args.root else _find_root(Path.cwd())
    if not (root / "src" / "repro_torch").is_dir():
        print(f"error: {root} does not look like the repo root "
              "(no src/repro_torch)", file=sys.stderr)
        return 2
    baseline_path = (
        args.baseline if args.baseline else root / DEFAULT_BASELINE
    )

    report = run_analysis(root, DEFAULT_CONFIG, baseline_path=baseline_path)

    if args.update_baseline:
        payload = baseline_payload(
            report.violations + report.baselined
        )
        baseline_path.write_text(json.dumps(payload, indent=2) + "\n")
        print(f"baseline rewritten: {len(payload['entries'])} entries "
              f"-> {baseline_path}")
        return 0

    if args.out:
        args.out.write_text(json.dumps(report.to_dict(), indent=2) + "\n")
    if args.json:
        print(json.dumps(report.to_dict(), indent=2))
    else:
        for v in report.violations:
            print(v.format())
        if report.stale_baseline:
            for e in report.stale_baseline:
                print(f"stale baseline entry: [{e['rule']}] {e['path']}: "
                      f"{e['message']}")
        if args.strict and report.unused_suppressions:
            for path, s in report.unused_suppressions:
                print(f"{path}:{s.line}: unused suppression for "
                      f"[{s.rule}]")
        n_checked = len(report.checked_files)
        n_sup = len(report.suppressed)
        n_base = len(report.baselined)
        status = "OK" if report.ok(args.strict) else "FAIL"
        print(
            f"{status}: {n_checked} files checked, "
            f"{len(report.violations)} new finding(s), "
            f"{n_sup} suppressed, {n_base} baselined",
        )

    ok = report.ok(args.strict)
    if args.strict and report.unused_suppressions:
        ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
