"""``unsafe-deserialization`` — checkpoints are pickle-free; the wire
deserializes through the restricted unpickler only.

``checkpoint/io.py`` deliberately serializes as JSON skeleton + npz
arrays so a checkpoint can never execute code on load (the JAX package's
docs/fault_tolerance.md "Checkpoint format"); this rule pins that:
no ``pickle``/``marshal``/``shelve``/``dill`` imports, no
``eval``/``exec``, and every ``np.load`` must pass
``allow_pickle=False`` explicitly.

On the wire (``dist``), payloads cross a trust boundary — a TCP frame
is attacker-controllable in principle — so raw ``pickle.loads`` /
``pickle.load`` calls are flagged; deserialization must go through
``repro_torch.dist.net.safe_loads`` (a restricted ``pickle.Unpickler``
allowlisting builtins + numpy array/scalar reconstruction).
``pickle.dumps`` (serialize *out*) stays allowed.
"""

from __future__ import annotations

import ast

from ..astutil import dotted_name
from ..engine import Rule, Violation, register_rule

_BANNED_MODULES = {"pickle", "cPickle", "dill", "marshal", "shelve"}
_WIRE_BANNED_CALLS = {
    "pickle.loads", "pickle.load", "cPickle.loads", "cPickle.load",
    "dill.loads", "dill.load", "marshal.loads", "marshal.load",
}


class UnsafeDeserializationRule(Rule):
    id = "unsafe-deserialization"
    description = (
        "no pickle/marshal/eval in checkpoint code; wire payloads in "
        "dist/ must deserialize via the restricted unpickler"
    )

    def check_file(self, ctx):
        opts = ctx.options
        banned_zone = any(ctx.path.startswith(p)
                          for p in opts.get("ban_under", []))
        wire_zone = any(ctx.path.startswith(p)
                        for p in opts.get("wire_under", []))
        out: list[Violation] = []
        for node in ast.walk(ctx.tree):
            if banned_zone and isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = (
                    [a.name for a in node.names]
                    if isinstance(node, ast.Import)
                    else [node.module or ""]
                )
                for mod in mods:
                    if mod.split(".")[0] in _BANNED_MODULES:
                        out.append(Violation(
                            self.id, ctx.path, node.lineno, node.col_offset,
                            f"import of {mod!r} in checkpoint code: "
                            "checkpoints must stay code-execution-free "
                            "(JSON skeleton + npz arrays)",
                        ))
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name is None:
                continue
            if (banned_zone or wire_zone) and name in ("eval", "exec"):
                out.append(Violation(
                    self.id, ctx.path, node.lineno, node.col_offset,
                    f"{name}() on data is arbitrary code execution",
                ))
            if banned_zone and name in ("np.load", "numpy.load"):
                kw = {k.arg: k.value for k in node.keywords}
                ap = kw.get("allow_pickle")
                if not (isinstance(ap, ast.Constant) and ap.value is False):
                    out.append(Violation(
                        self.id, ctx.path, node.lineno, node.col_offset,
                        "np.load must pass allow_pickle=False explicitly",
                    ))
            if wire_zone and name in _WIRE_BANNED_CALLS:
                out.append(Violation(
                    self.id, ctx.path, node.lineno, node.col_offset,
                    f"raw {name}() on a wire payload executes arbitrary "
                    "globals; use repro_torch.dist.net.safe_loads (restricted "
                    "unpickler)",
                ))
        return out


register_rule(UnsafeDeserializationRule())
