"""Core machinery of the port's contract linter (``repro_torch.analysis``).

The port's correctness rests on hand-enforced contracts — the lockstep
kernels stay on the device and never read a tensor back to the host, the
grid-fusion hooks stay closed, the simulation core is deterministic,
checkpoints are pickle-free, and the ``dist`` wire protocol keeps senders
and handlers in sync.  This module is the rule-agnostic half of the
static-analysis pass that enforces them: file collection from per-rule
scopes, the rule registry, ``# repro: allow[rule-id]: reason`` suppressions
(reason mandatory), a checked-in baseline so a run gates on *no new*
violations, and the text/JSON reports.  The contracts themselves live in
``repro_torch.analysis.rules``.  It is the JAX package's engine
(``repro.analysis.engine``), copied so the port imports nothing of it.

Design constraints:

* stdlib only (``ast`` + ``json``) — the linter must run in the tier-1
  CI job before anything heavy imports;
* every rule is pure AST → findings; no imports of the code under
  analysis, so a broken module can still be linted;
* suppressions are *positional* (same line or the line directly above)
  and carry a mandatory reason — an allow without a reason is itself a
  violation (``suppression-syntax``);
* baseline entries match on ``(rule, path, message)`` — not line
  numbers — so unrelated edits don't churn the baseline.
"""

from __future__ import annotations

import ast
import fnmatch
import io
import json
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path

__all__ = [
    "FileContext",
    "ProjectContext",
    "Report",
    "Rule",
    "RULES",
    "Suppression",
    "Violation",
    "load_baseline",
    "register_rule",
    "run_analysis",
    "run_on_sources",
]


@dataclass(frozen=True)
class Violation:
    """One finding: a contract breach at a source location."""

    rule: str
    path: str          # repo-relative posix path
    line: int
    col: int
    message: str

    def fingerprint(self) -> tuple[str, str, str]:
        """Baseline identity: line numbers excluded on purpose so the
        baseline survives unrelated edits above the finding."""
        return (self.rule, self.path, self.message)

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
        }

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


@dataclass(frozen=True)
class Suppression:
    """One parsed ``# repro: allow[rule-id]: reason`` comment."""

    rule: str
    line: int
    reason: str
    file_scope: bool = False   # ``allow-file``: whole-file suppression


# Matches ``repro: allow[rule-id]: reason`` (and the allow-file
# variant) inside comment tokens.
_ALLOW_RE = re.compile(
    r"#\s*repro:\s*(allow(?:-file)?)\[([A-Za-z0-9_-]+)\]\s*(?::\s*(\S.*))?$"
)

SUPPRESSION_RULE_ID = "suppression-syntax"


class Rule:
    """One contract.  Subclasses set ``id``/``description`` and
    implement ``check_file`` (per-file findings) and/or
    ``check_project`` (cross-file findings, e.g. protocol balance).

    File scope comes from the per-rule config (``files`` globs, see
    ``repro_torch.analysis.config``); a rule only sees files its scope
    matches, so discipline can be absolute where it applies without
    drowning unrelated modules in findings.
    """

    id: str = "abstract"
    description: str = ""

    def check_file(self, ctx: "FileContext") -> list[Violation]:
        return []

    def check_project(self, project: "ProjectContext") -> list[Violation]:
        return []


RULES: dict[str, Rule] = {}


def register_rule(rule: Rule) -> Rule:
    if rule.id in RULES:
        raise ValueError(f"duplicate rule id {rule.id!r}")
    RULES[rule.id] = rule
    return rule


class _SuppressionSyntaxRule(Rule):
    """Meta-rule: malformed ``# repro: allow[...]`` comments (missing
    reason, unknown rule id).  Findings are emitted by the engine while
    parsing suppressions; registering the id keeps the registry checks
    (tests/test_torch_analysis.py) closed over every id a report can
    carry."""

    id = SUPPRESSION_RULE_ID
    description = (
        "every `# repro: allow[rule-id]: reason` suppression must name a "
        "registered rule and carry a non-empty reason"
    )


register_rule(_SuppressionSyntaxRule())


@dataclass
class FileContext:
    """Everything a file-scoped rule check needs."""

    path: str                      # repo-relative posix path
    source: str
    tree: ast.AST
    options: dict                  # this rule's config (scope + knobs)
    lines: list[str] = field(default_factory=list)

    def segment(self, node: ast.AST) -> str:
        return ast.get_source_segment(self.source, node) or ""

    def module_str_constants(self) -> dict[str, str]:
        """Module-level ``NAME = "literal"`` assignments — lets rules
        resolve symbolic tags like ``HELLO_KIND``."""
        out: dict[str, str] = {}
        for node in self.tree.body:
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)
            ):
                out[node.targets[0].id] = node.value.value
        return out


@dataclass
class ProjectContext:
    """Cross-file view handed to ``check_project`` rules."""

    files: dict[str, FileContext]  # path -> context (this rule's scope)


@dataclass
class Report:
    """Outcome of one analysis run."""

    violations: list[Violation]          # new (unsuppressed, unbaselined)
    suppressed: list[tuple[Violation, Suppression]]
    baselined: list[Violation]
    stale_baseline: list[dict]           # baseline entries that no longer fire
    unused_suppressions: list[tuple[str, Suppression]]
    checked_files: list[str]

    def ok(self, strict: bool = False) -> bool:
        if self.violations:
            return False
        if strict and self.stale_baseline:
            return False
        return True

    def to_dict(self) -> dict:
        return {
            "version": 1,
            "ok": self.ok(),
            "checked_files": sorted(self.checked_files),
            "violations": [v.to_dict() for v in self.violations],
            "suppressed": [
                {**v.to_dict(), "reason": s.reason}
                for v, s in self.suppressed
            ],
            "baselined": [v.to_dict() for v in self.baselined],
            "stale_baseline": list(self.stale_baseline),
            "unused_suppressions": [
                {"path": p, "line": s.line, "rule": s.rule}
                for p, s in self.unused_suppressions
            ],
            "rules": {r.id: r.description for r in RULES.values()},
        }


def _comment_lines(source: str) -> list[tuple[int, str]]:
    """(lineno, comment text) for every real comment token — tokenizing
    rather than line-scanning so docstrings that *mention* the allow
    syntax (like this module's) are never parsed as suppressions."""
    out: list[tuple[int, str]] = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type == tokenize.COMMENT:
                out.append((tok.start[0], tok.string))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        # unparseable tail; the ast pass reports the syntax error
        pass
    return out


def parse_suppressions(path: str, source: str) -> tuple[list[Suppression], list[Violation]]:
    """All well-formed suppressions in ``source`` plus syntax findings
    for the malformed ones (missing reason / unknown rule id)."""
    sups: list[Suppression] = []
    bad: list[Violation] = []
    for lineno, text in _comment_lines(source):
        m = _ALLOW_RE.search(text)
        if not m:
            continue
        kind, rule_id, reason = m.group(1), m.group(2), m.group(3)
        if rule_id not in RULES:
            bad.append(Violation(
                SUPPRESSION_RULE_ID, path, lineno, 0,
                f"suppression names unknown rule {rule_id!r}",
            ))
            continue
        if not reason or not reason.strip():
            bad.append(Violation(
                SUPPRESSION_RULE_ID, path, lineno, 0,
                f"suppression for {rule_id!r} is missing its mandatory "
                "reason (`# repro: allow[rule]: reason`)",
            ))
            continue
        sups.append(Suppression(
            rule=rule_id, line=lineno, reason=reason.strip(),
            file_scope=(kind == "allow-file"),
        ))
    return sups, bad


def _match_scope(path: str, patterns: list[str]) -> bool:
    return any(fnmatch.fnmatch(path, pat) for pat in patterns)


def _collect_files(root: Path, config: dict) -> dict[str, str]:
    """Union of every rule's file scope, loaded once."""
    sources: dict[str, str] = {}
    for rule_id, opts in config.items():
        for pat in opts.get("files", []):
            for fs_path in sorted(root.glob(pat)):
                if not fs_path.is_file():
                    continue
                rel = fs_path.relative_to(root).as_posix()
                if rel not in sources:
                    sources[rel] = fs_path.read_text()
    return sources


def _apply_suppressions(
    violations: list[Violation],
    sup_by_file: dict[str, list[Suppression]],
):
    """Match findings against suppressions: a violation is suppressed
    by an ``allow`` on its own line or the line directly above, or by
    an ``allow-file`` anywhere in its file."""
    new: list[Violation] = []
    suppressed: list[tuple[Violation, Suppression]] = []
    used: set[tuple[str, int]] = set()
    for v in violations:
        hit = None
        for s in sup_by_file.get(v.path, []):
            if s.rule != v.rule:
                continue
            if s.file_scope or s.line in (v.line, v.line - 1):
                hit = s
                break
        if hit is None:
            new.append(v)
        else:
            suppressed.append((v, hit))
            used.add((v.path, hit.line))
    unused = [
        (path, s)
        for path, sups in sup_by_file.items()
        for s in sups
        if (path, s.line) not in used
    ]
    return new, suppressed, unused


def load_baseline(path: Path) -> list[dict]:
    if not path.is_file():
        return []
    data = json.loads(path.read_text())
    entries = data.get("entries", [])
    for e in entries:
        for key in ("rule", "path", "message"):
            if key not in e:
                raise ValueError(f"baseline entry missing {key!r}: {e}")
    return entries


def baseline_payload(violations: list[Violation]) -> dict:
    entries = sorted(
        ({"rule": v.rule, "path": v.path, "message": v.message}
         for v in violations),
        key=lambda e: (e["rule"], e["path"], e["message"]),
    )
    return {"version": 1, "entries": entries}


def _apply_baseline(violations: list[Violation], entries: list[dict]):
    """Consume baseline entries by fingerprint (each entry absorbs one
    finding); leftovers on either side are new findings / stale
    entries."""
    budget: dict[tuple[str, str, str], int] = {}
    for e in entries:
        key = (e["rule"], e["path"], e["message"])
        budget[key] = budget.get(key, 0) + 1
    new: list[Violation] = []
    baselined: list[Violation] = []
    for v in violations:
        key = v.fingerprint()
        if budget.get(key, 0) > 0:
            budget[key] -= 1
            baselined.append(v)
        else:
            new.append(v)
    stale = [
        {"rule": k[0], "path": k[1], "message": k[2], "count": n}
        for k, n in sorted(budget.items())
        if n > 0
    ]
    return new, baselined, stale


def run_on_sources(
    sources: dict[str, str],
    config: dict,
    baseline: list[dict] | None = None,
) -> Report:
    """Run every registered rule over in-memory ``{path: source}``
    files — the full pipeline (scoping, suppressions, baseline) minus
    the filesystem.  This is also what the rule self-tests drive."""
    contexts: dict[str, FileContext] = {}
    violations: list[Violation] = []
    sup_by_file: dict[str, list[Suppression]] = {}

    for path, source in sources.items():
        sups, bad = parse_suppressions(path, source)
        sup_by_file[path] = sups
        violations.extend(bad)
        try:
            tree = ast.parse(source)
        except SyntaxError as exc:
            violations.append(Violation(
                SUPPRESSION_RULE_ID, path, exc.lineno or 0, 0,
                f"file does not parse: {exc.msg}",
            ))
            continue
        contexts[path] = FileContext(
            path=path, source=source, tree=tree, options={},
            lines=source.splitlines(),
        )

    for rule in RULES.values():
        opts = config.get(rule.id, {})
        scope = opts.get("files", [])
        in_scope = {
            p: FileContext(
                path=c.path, source=c.source, tree=c.tree,
                options=opts, lines=c.lines,
            )
            for p, c in contexts.items()
            if _match_scope(p, scope)
        }
        for ctx in in_scope.values():
            violations.extend(rule.check_file(ctx))
        if in_scope:
            violations.extend(rule.check_project(ProjectContext(in_scope)))

    violations.sort(key=lambda v: (v.path, v.line, v.rule, v.message))
    new, suppressed, unused = _apply_suppressions(violations, sup_by_file)
    new, baselined, stale = _apply_baseline(new, baseline or [])
    return Report(
        violations=new,
        suppressed=suppressed,
        baselined=baselined,
        stale_baseline=stale,
        unused_suppressions=unused,
        checked_files=sorted(sources),
    )


def run_analysis(
    root: Path,
    config: dict,
    baseline_path: Path | None = None,
) -> Report:
    """Analyze the repo at ``root`` with ``config`` scopes; the
    baseline (if present) absorbs known findings."""
    sources = _collect_files(root, config)
    baseline = load_baseline(baseline_path) if baseline_path else []
    return run_on_sources(sources, config, baseline)
