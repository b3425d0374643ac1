"""``blanket-except`` — no ``except Exception`` in engine/dist code.

A blanket handler swallows the exact failures the differential suites
exist to surface (a shape error inside a kernel, a decode mismatch, an
unpicklable message) and converts them into silent fallbacks.  Catch
the concrete types the operation can actually raise.  The deliberate
exceptions — child-process teardown races in ``dist``, where an
arbitrary error from a dying interpreter must not take the master down
— carry inline ``allow`` suppressions stating so.
"""

from __future__ import annotations

import ast

from ..engine import Rule, Violation, register_rule


class BlanketExceptRule(Rule):
    id = "blanket-except"
    description = (
        "except clauses in core/dist must name concrete exception types, "
        "not Exception/BaseException or bare except"
    )

    def check_file(self, ctx):
        out: list[Violation] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            bad = None
            if node.type is None:
                bad = "bare except"
            elif isinstance(node.type, ast.Name) and node.type.id in (
                "Exception", "BaseException"
            ):
                bad = f"except {node.type.id}"
            elif isinstance(node.type, ast.Tuple) and any(
                isinstance(e, ast.Name)
                and e.id in ("Exception", "BaseException")
                for e in node.type.elts
            ):
                bad = "except tuple containing Exception"
            if bad:
                out.append(Violation(
                    self.id, ctx.path, node.lineno, node.col_offset,
                    f"{bad}: name the concrete exception types this "
                    "operation raises",
                ))
        return out


register_rule(BlanketExceptRule())
