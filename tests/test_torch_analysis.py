"""The port's contract linter (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``).

* **live** — the linter is clean on the port, every scope's files are
  checked, and every suppression is used and carries a reason;
* **parity** — the rules whose logic carries over unchanged give the
  reference's findings, as (rule, line, message), on the fixture sources of
  ``tests/test_analysis.py`` planted at the port's paths;
* **seeded** — each port-scoped rule trips on a violation in the port's
  idiom, planted in the port's own ``core/kernel.py`` where it binds;
* **CLI** — exit codes, ``--json`` in the reference's schema.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import DEFAULT_CONFIG, RULES, run_analysis, run_on_sources
from repro_torch.analysis.engine import SUPPRESSION_RULE_ID

REPO = Path(__file__).resolve().parent.parent
KERNEL = "src/repro_torch/core/kernel.py"
BASELINE = REPO / "src/repro_torch/analysis/baseline.json"


def findings(sources, rule_id):
    return [v for v in run_on_sources(sources, DEFAULT_CONFIG).violations if v.rule == rule_id]


# -- the live tree ----------------------------------------------------------------------


def test_the_port_is_clean_and_every_scope_is_checked():
    report = run_analysis(REPO, DEFAULT_CONFIG, baseline_path=BASELINE)
    assert report.violations == [], [v.format() for v in report.violations]
    assert report.ok(strict=True) and report.unused_suppressions == []
    assert all(s.reason for _, s in report.suppressed)
    # the gate's three sanctioned host reads are the kernel module's only pardons
    assert sorted((v.rule, v.path) for v, _ in report.suppressed if v.path == KERNEL) == \
        [("tracer-safety", KERNEL)] * 3
    checked = set(report.checked_files)
    for rule_id, opts in DEFAULT_CONFIG.items():
        assert rule_id in RULES
        for pat in opts["files"]:
            hits = {p.relative_to(REPO).as_posix() for p in REPO.glob(pat) if p.is_file()}
            assert hits and hits <= checked, (rule_id, pat)
    for new in ("launch/dryrun.py", "launch/perf.py", "launch/comm_census.py",
                "launch/scenarios.py", "core/batch.py", "core/kernel.py"):
        assert f"src/repro_torch/{new}" in checked
    assert not any(p.startswith("src/repro/") for p in checked)


def test_rules_and_scopes_mirror_the_reference():
    from repro.analysis import DEFAULT_CONFIG as REF_CONFIG
    from repro.analysis import RULES as REF_RULES

    assert set(RULES) == set(REF_RULES) == set(DEFAULT_CONFIG) | {SUPPRESSION_RULE_ID}
    assert set(DEFAULT_CONFIG) == set(REF_CONFIG)
    for rule_id, ref in REF_CONFIG.items():
        port = [p.replace("src/repro_torch/", "src/repro/") for p in DEFAULT_CONFIG[rule_id]["files"]]
        assert port == ref["files"], rule_id


def test_the_port_imports_nothing_of_the_reference():
    for path in (REPO / "src/repro_torch/analysis").rglob("*.py"):
        text = path.read_text()
        assert not re.search(r"^\s*(from|import)\s+(repro|jax)\b(?!_torch)", text, re.M), path


# -- parity with the reference on tests/test_analysis.py's fixtures -------------------------

_BAD_EXCEPT = ("def f():\n    try:\n        pass\n    except Exception:{comment}\n"
               "        pass\n")
_CKPT, _DIST, _CORE, _LAUNCH = ("checkpoint/store.py", "dist/wire.py", "core/x.py",
                                "launch/tool.py")
_W, _S = "dist/worker.py", "dist/supervisor.py"

FIXTURES = {
    "clock-in-core": {_CORE: "import time\nT0 = time.perf_counter()\n"},
    "unseeded-rng": {_CORE: "import numpy as np\nrng = np.random.default_rng()\n"},
    "global-rng": {_CORE: "import random\nimport numpy as np\nx = np.random.rand(3)\n"
                          "y = random.random()\n"},
    "seeded-rng": {_CORE: "import numpy as np\nrng = np.random.default_rng(42)\n"},
    "wall-clock-in-launch": {_LAUNCH: "import time\nt0 = time.time()\n"},
    "perf-counter-in-launch": {_LAUNCH: "import time\nt0 = time.perf_counter()\n"},
    "pickle-in-checkpoint": {_CKPT: "import pickle\n"},
    "np-load": {_CKPT: "import numpy as np\ndef f(p):\n    return np.load(p)\n"},
    "np-load-no-pickle": {_CKPT: "import numpy as np\ndef f(p):\n"
                                 "    return np.load(p, allow_pickle=False)\n"},
    "pickle-loads-on-wire": {_DIST: "import pickle\ndef f(payload):\n"
                                    "    return pickle.loads(payload)\n"},
    "pickle-dumps-on-wire": {_DIST: "import pickle\ndef f(msg):\n    return pickle.dumps(msg)\n"},
    "blanket-three-forms": {_CORE: (
        "def f():\n    try:\n        pass\n    except Exception:\n        pass\n"
        "    try:\n        pass\n    except (ValueError, BaseException):\n        pass\n"
        "    try:\n        pass\n    except:\n        pass\n")},
    "concrete-types": {_CORE: "def f():\n    try:\n        pass\n"
                              "    except (ValueError, OSError):\n        pass\n"},
    "protocol-balanced": {
        _W: ("def serve(conn):\n    msg = conn.recv()\n    kind = msg.get(\"kind\")\n"
             "    if kind == \"ping\":\n        conn.send({\"kind\": \"pong\"})\n"),
        _S: ("def pump(conn):\n    conn.send({\"kind\": \"ping\"})\n"
             "    if conn.recv().get(\"kind\") == \"pong\":\n        return True\n")},
    "protocol-unhandled": {_S: "def go(conn):\n    conn.send({\"kind\": \"mystery\"})\n"},
    "protocol-unsent": {_W: "def serve(msg):\n    if msg.get(\"kind\") == \"ghost\":\n"
                            "        return 1\n"},
    "protocol-binding": {
        _S: ("def go(sup, links):\n    msgs = {}\n    for l in links:\n"
             "        msgs[l] = {\"kind\": \"work\"}\n        sup.dispatch(l, msgs[l])\n"),
        _W: "def serve(msg):\n    if msg[\"kind\"] == \"work\":\n        return 1\n"},
    "protocol-constants": {_S: ("HELLO = \"__hi__\"\ndef go(conn):\n"
                                "    conn.send({\"kind\": HELLO})\n"
                                "    if conn.recv().get(\"kind\") == HELLO:\n"
                                "        return True\n")},
    "allow-same-line": {_CORE: _BAD_EXCEPT.format(
        comment="  # repro: allow[blanket-except]: teardown boundary")},
    "allow-line-above": {_CORE: ("def f():\n    try:\n        pass\n"
                                 "    # repro: allow[blanket-except]: teardown boundary\n"
                                 "    except Exception:\n        pass\n")},
    "allow-no-reason": {_CORE: _BAD_EXCEPT.format(comment="  # repro: allow[blanket-except]")},
    "allow-unknown-rule": {_CORE: "x = 1  # repro: allow[no-such-rule]: whatever\n"},
    "allow-in-docstring": {_CORE: '"""Docs may mention # repro: allow[blanket-except] '
                                  'freely."""\nx = 1\n'},
    "allow-wrong-rule": {_CORE: _BAD_EXCEPT.format(
        comment="  # repro: allow[determinism]: mismatched id")},
    "allow-file": {_CORE: "# repro: allow-file[blanket-except]: generated adapter\n"
                          + _BAD_EXCEPT.format(comment="")},
}
#: the rules whose logic the port carries over unchanged
CARRIED = ("determinism", "unsafe-deserialization", "blanket-except",
           "protocol-exhaustiveness", SUPPRESSION_RULE_ID)


def _summary(report, pkg):
    """Findings, pardons and unused pardons as the reference would name them."""
    def norm(v):
        return (v.rule, v.path.replace(f"src/{pkg}/", ""), v.line,
                v.message.replace("repro_torch.", "repro."))

    return ([norm(v) for v in report.violations if v.rule in CARRIED],
            sorted((norm(v), s.reason) for v, s in report.suppressed),
            sorted((p.replace(f"src/{pkg}/", ""), s.line, s.rule)
                   for p, s in report.unused_suppressions))


@pytest.mark.parametrize("case", list(FIXTURES))
def test_carried_over_rules_match_the_reference(case):
    from repro.analysis import DEFAULT_CONFIG as REF_CONFIG
    from repro.analysis import run_on_sources as ref_run

    files = FIXTURES[case]
    want = _summary(ref_run({f"src/repro/{p}": s for p, s in files.items()}, REF_CONFIG),
                    "repro")
    got = _summary(run_on_sources({f"src/repro_torch/{p}": s for p, s in files.items()},
                                  DEFAULT_CONFIG), "repro_torch")
    assert got == want
    if case in ("clock-in-core", "pickle-in-checkpoint", "protocol-unhandled",
                "blanket-three-forms", "allow-no-reason"):
        assert got[0]  # the fixture trips


def test_baseline_absorbs_and_goes_stale_as_the_reference():
    src = _BAD_EXCEPT.format(comment="")
    path = "src/repro_torch/core/x.py"
    v = run_on_sources({path: src}, DEFAULT_CONFIG).violations[0]
    entry = {"rule": v.rule, "path": v.path, "message": v.message}
    report = run_on_sources({path: src + src.replace("def f", "def g")}, DEFAULT_CONFIG,
                            baseline=[entry])
    assert len(report.baselined) == 1 and len(report.violations) == 1
    gone = run_on_sources({path: "x = 1\n"}, DEFAULT_CONFIG, baseline=[entry])
    assert gone.ok(strict=False) and not gone.ok(strict=True)


# -- each port-scoped rule trips on a seeded violation in the port's idiom ------------------


def _kernel_source():
    return (REPO / KERNEL).read_text()


def _plant(anchor, line):
    """The port's kernel module with ``line`` planted after ``anchor``
    (matching its indentation)."""
    src = _kernel_source()
    assert src.count(anchor) == 1, anchor
    indent = re.match(r"\s*", anchor.splitlines()[-1]).group(0)
    return src.replace(anchor, f"{anchor}\n{indent}{line}")


SBGC_STEP = "        can = _cluster_counts_ok(stragglers, self.block_of, self.C, self.s)"
SEEDED = {
    "item-in-step": ("tracer-safety", KERNEL, lambda: _plant(
        SBGC_STEP, "n_late = state.dead.sum().item()"), ".item() in `step`"),
    "cpu-in-step": ("tracer-safety", KERNEL, lambda: _plant(
        SBGC_STEP, "late = state.dead.cpu()"), ".cpu() in `step`"),
    "cast-in-step": ("tracer-safety", KERNEL, lambda: _plant(
        SBGC_STEP, "late = bool(can.all())"), "bool() on a per-cell value in `step`"),
    "branch-in-step": ("tracer-safety", KERNEL, lambda: _plant(
        SBGC_STEP, "if stragglers.any():\n            return state"), "`if` in `step`"),
    "np-in-step": ("backend-shim", KERNEL, lambda: _plant(
        SBGC_STEP, "can = np.logical_and(can, True)"), "raw np.logical_and()"),
    "jax-import": ("backend-shim", KERNEL, lambda: "import jax.numpy as jnp\n"
                   + _kernel_source(), "module-level import of 'jax.numpy'"),
    "fused-without-bind": ("fused-contract", KERNEL, lambda: _kernel_source().replace(
        "    def bind_fused(self, scalars: dict):\n        return _bind_cluster_s(self, scalars)\n"
        "\n    def init_state(self, cells: int) -> DCGCState:",
        "    def init_state(self, cells: int) -> DCGCState:"),
        "class DCGCKernel declares fused_params ['s'] but defines no bind_fused()"),
    "branch-on-fused": ("fused-contract", KERNEL, lambda: _plant(
        SBGC_STEP, "if self.s > 0:\n            can = can & True"),
        "SBGCKernel.step branches on fused scalar(s) s"),
    "bare-except-in-core": ("blanket-except", "src/repro_torch/core/batch.py", lambda: (
        REPO / "src/repro_torch/core/batch.py").read_text().replace(
        "        except ValueError:\n            if strict:\n                raise\n"
        "            out[e.si, e.ki]", "        except:\n            if strict:\n"
        "                raise\n            out[e.si, e.ki]"), "bare except"),
    "pickle-in-checkpoint": ("unsafe-deserialization", "src/repro_torch/checkpoint/io.py",
                             lambda: "import pickle\n" + (
                                 REPO / "src/repro_torch/checkpoint/io.py").read_text(),
                             "import of 'pickle' in checkpoint code"),
    "clock-in-core": ("determinism", "src/repro_torch/core/batch.py", lambda: (
        REPO / "src/repro_torch/core/batch.py").read_text() + "\nT0 = time.time()\n",
        "clock read time.time()"),
}


@pytest.mark.parametrize("case", list(SEEDED))
def test_each_port_rule_catches_its_seeded_violation(case):
    rule, path, source, text = SEEDED[case]
    planted = source()
    assert planted != (REPO / path).read_text()
    got = findings({path: planted}, rule)
    assert len(got) == 1 and text in got[0].message, [v.format() for v in got]
    # and the tree as it is stays quiet under the same rule
    assert findings({path: (REPO / path).read_text()}, rule) == []


def test_the_gate_reads_the_host_only_where_pardoned():
    """Without its three pragmas, tracer-safety flags exactly the gate's
    three sanctioned checks (the ones GateKernel.host_syncs counts): a round's
    "anything to wait out", the greedy loop's "anything unresolved", and the
    variant check's largest candidate count (a gate that is not analytic)."""
    src = "\n".join(line for line in _kernel_source().splitlines()
                    if "repro: allow[tracer-safety]" not in line) + "\n"
    got = findings({KERNEL: src}, "tracer-safety")
    assert [v.message.split("`")[-2] for v in got] == ["admit_partial", "_wait_out",
                                                       "_wait_out_variants"]
    assert all("_host_check" in src.splitlines()[v.line - 1] for v in got)


# -- the CLI ----------------------------------------------------------------------------


def _run(module, *args, cwd=REPO):
    return subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                          text=True, cwd=cwd,
                          env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})


def test_cli_strict_json_and_exit_codes(tmp_path):
    proc = _run("repro_torch.analysis", "--strict")
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stdout + proc.stderr
    proc = _run("repro_torch.analysis", "--list-rules")
    assert proc.returncode == 0 and all(r in proc.stdout for r in RULES)
    assert _run("repro_torch.analysis", "--root", str(tmp_path)).returncode == 2
    fake = tmp_path / "src" / "repro_torch" / "core"
    fake.mkdir(parents=True)
    (fake / "bad.py").write_text("import time\nT = time.time()\n")
    proc = _run("repro_torch.analysis", "--root", str(tmp_path))
    assert proc.returncode == 1 and "determinism" in proc.stdout
    # --json: the reference's schema, key for key
    got = json.loads(_run("repro_torch.analysis", "--json").stdout)
    want = json.loads(_run("repro.analysis", "--json").stdout)
    assert set(got) == set(want) and got["version"] == want["version"] == 1
    assert got["ok"] is True and set(got["rules"]) == set(want["rules"])
    for key in ("suppressed", "violations", "baselined", "stale_baseline",
                "unused_suppressions"):
        assert isinstance(got[key], list)
    assert set(got["suppressed"][0]) == set(want["suppressed"][0]) == \
        {"rule", "path", "line", "col", "message", "reason"}
    assert all(p.startswith("src/repro_torch/") for p in got["checked_files"])
