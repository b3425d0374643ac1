"""``protocol-exhaustiveness`` — every wire tag is both sent and handled.

The distributed harness speaks dict messages tagged by a ``"kind"``
field (the JAX package's docs/distributed.md).  The failure mode this rule exists for is
drift: a new tag sent by the master with no worker handler is silently
dropped by ``msg.get("kind")`` dispatch (no error, just a hang or a
missed reconfig); a handler for a tag nobody sends is dead code that
reads as load-bearing.  Both directions are cross-checked over the
whole ``dist`` scope in one project pass:

* **sent tags** — string values of ``"kind"`` keys in dict literals
  that flow into a send-like call (``send``, ``sendall``, ``dispatch``,
  ``resend``, ``broadcast``, ``dumps``), either nested directly in the
  call or via a name/subscript assigned earlier in the same function
  (``msgs[l] = {...}; sup.dispatch(p, g, msgs[l])``).  String constants
  resolve through module-level constants (``HELLO_KIND``).
* **handled tags** — string constants compared (``==``, ``!=``, ``in``,
  ``not in``) against a kind-read: ``msg.get("kind")``,
  ``msg["kind"]``, or a name assigned from one
  (``kind = msg.get("kind")``).

A tag in one set but not the other is a violation at each site.  Tags
in dict literals that never reach a send call (local event records,
ledger entries) are deliberately NOT collected — only what crosses the
wire counts.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass

from ..astutil import iter_functions
from ..engine import Rule, Violation, register_rule

_SEND_CALLEES = {"send", "sendall", "dispatch", "resend", "broadcast", "dumps"}


@dataclass
class _TagSite:
    tag: str
    path: str
    line: int
    col: int


def _const_str(node: ast.AST, consts: dict[str, str]) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    return None


def _module_str_consts(tree: ast.Module) -> dict[str, str]:
    out: dict[str, str] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant):
            if isinstance(node.value.value, str):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        out[tgt.id] = node.value.value
    return out


def _kind_of_dict(node: ast.Dict, consts) -> str | None:
    for k, v in zip(node.keys, node.values):
        if isinstance(k, ast.Constant) and k.value == "kind":
            return _const_str(v, consts)
    return None


def _is_kind_read(node: ast.AST) -> bool:
    """``x.get("kind")`` or ``x["kind"]``."""
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "get"
        and node.args
        and isinstance(node.args[0], ast.Constant)
        and node.args[0].value == "kind"
    ):
        return True
    if (
        isinstance(node, ast.Subscript)
        and isinstance(node.slice, ast.Constant)
        and node.slice.value == "kind"
    ):
        return True
    return False


class ProtocolExhaustivenessRule(Rule):
    id = "protocol-exhaustiveness"
    description = (
        "every wire message tag sent in dist/ has a handler, and every "
        "handled tag has a sender"
    )

    def check_project(self, project):
        sent: list[_TagSite] = []
        handled: list[_TagSite] = []
        for ctx in project.files.values():
            consts = _module_str_consts(ctx.tree)
            self._collect_sent(ctx, consts, sent)
            self._collect_handled(ctx, consts, handled)

        sent_tags = {s.tag for s in sent}
        handled_tags = {h.tag for h in handled}
        out: list[Violation] = []
        for s in sent:
            if s.tag not in handled_tags:
                out.append(Violation(
                    self.id, s.path, s.line, s.col,
                    f"message kind {s.tag!r} is sent here but no handler "
                    "in dist/ compares against it — receivers will "
                    "silently drop it",
                ))
        for h in handled:
            if h.tag not in sent_tags:
                out.append(Violation(
                    self.id, h.path, h.line, h.col,
                    f"handler compares against kind {h.tag!r} but nothing "
                    "in dist/ sends it — dead protocol arm",
                ))
        return out

    # -- sent side -------------------------------------------------------
    def _collect_sent(self, ctx, consts, sent: list[_TagSite]):
        funcs = [f for f, _cls in iter_functions(ctx.tree)]
        # module top level counts as one scope too
        scopes: list[ast.AST] = funcs + [ctx.tree]
        owned: set[int] = set()
        for f in funcs:
            for sub in ast.walk(f):
                if sub is not f:
                    owned.add(id(sub))

        for scope in scopes:
            # bindings: textual key ("name" / "name[sub]") -> tag
            bindings: dict[str, _TagSite] = {}
            nodes = (
                [n for n in ast.walk(scope)]
                if scope is not ctx.tree
                else [n for n in ast.walk(scope) if id(n) not in owned]
            )
            for node in nodes:
                if isinstance(node, ast.Assign):
                    tag = (
                        _kind_of_dict(node.value, consts)
                        if isinstance(node.value, ast.Dict) else None
                    )
                    if tag is None:
                        continue
                    for tgt in node.targets:
                        key = self._target_key(tgt)
                        if key:
                            bindings[key] = _TagSite(
                                tag, ctx.path, node.lineno, node.col_offset)
                elif isinstance(node, ast.Call):
                    # the receiver may be subscripted (self.links[i]),
                    # so take the callee leaf directly, not via
                    # dotted_name
                    if isinstance(node.func, ast.Attribute):
                        leaf = node.func.attr
                    elif isinstance(node.func, ast.Name):
                        leaf = node.func.id
                    else:
                        continue
                    if leaf not in _SEND_CALLEES:
                        continue
                    for arg in node.args:
                        # dict literal nested right in the call
                        for sub in ast.walk(arg):
                            if isinstance(sub, ast.Dict):
                                tag = _kind_of_dict(sub, consts)
                                if tag is not None:
                                    sent.append(_TagSite(
                                        tag, ctx.path,
                                        sub.lineno, sub.col_offset))
                        key = self._target_key(arg)
                        if key and key in bindings:
                            sent.append(bindings[key])

    @staticmethod
    def _target_key(node: ast.AST) -> str | None:
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name):
            idx = node.slice
            if isinstance(idx, ast.Name):
                return f"{node.value.id}[{idx.id}]"
            if isinstance(idx, ast.Constant):
                return f"{node.value.id}[{idx.value!r}]"
        return None

    # -- handled side ----------------------------------------------------
    def _collect_handled(self, ctx, consts, handled: list[_TagSite]):
        for func, _cls in iter_functions(ctx.tree):
            kind_names: set[str] = set()
            for node in ast.walk(func):
                if isinstance(node, ast.Assign) and _is_kind_read(node.value):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            kind_names.add(tgt.id)

            def is_kind_expr(node: ast.AST) -> bool:
                if _is_kind_read(node):
                    return True
                return isinstance(node, ast.Name) and node.id in kind_names

            for node in ast.walk(func):
                if not isinstance(node, ast.Compare):
                    continue
                operands = [node.left, *node.comparators]
                if not any(is_kind_expr(o) for o in operands):
                    continue
                ok_ops = (ast.Eq, ast.NotEq, ast.In, ast.NotIn)
                if not all(isinstance(op, ok_ops) for op in node.ops):
                    continue
                for o in operands:
                    tag = _const_str(o, consts)
                    if tag is not None:
                        handled.append(_TagSite(
                            tag, ctx.path, node.lineno, node.col_offset))
                    elif isinstance(o, (ast.Tuple, ast.List, ast.Set)):
                        for e in o.elts:
                            tag = _const_str(e, consts)
                            if tag is not None:
                                handled.append(_TagSite(
                                    tag, ctx.path, e.lineno, e.col_offset))


register_rule(ProtocolExhaustivenessRule())
