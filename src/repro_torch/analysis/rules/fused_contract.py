"""``fused-contract`` — the grid-fusion hooks stay closed.

A grid-fused ``simulate_batch`` (``core.batch``) runs the specs of one shape
bucket as one lockstep batch, each fused scalar bound per cell.  That works
only if a kernel upholds both halves of the protocol:

1. a class that declares a non-empty ``fused_params`` (class attribute or
   any ``self.fused_params = (...)`` assignment) must also define
   ``bind_fused`` — otherwise the planner stacks values that are never
   rebound, and every member of the bucket runs at the representative's
   threshold;
2. the fused scalar names it declares (e.g. ``s``, ``lam``) are
   ``(cells,)`` tensors inside non-host methods: a branch or loop test on
   one asks Python for the truth of a many-valued tensor, which raises (or,
   with one cell, reads it back to the host).  Mask arithmetic
   (``torch.where``, multiply-by-indicator) is the sanctioned form.

Host-side methods named in ``host_functions`` (constructors, ``bind_fused``
and ``fused_scalars`` themselves, ``init_state``) are exempt.
"""

from __future__ import annotations

import ast

from ..astutil import names_in
from ..engine import Rule, Violation, register_rule


def _mentions(node: ast.AST) -> set[str]:
    """Plain names plus attribute tails, so both ``s`` and ``self.s``
    resolve to the declared fused-scalar name."""
    got = set(names_in(node))
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute):
            got.add(n.attr)
    return got


def _fused_names_of(cls: ast.ClassDef) -> tuple[set[str], ast.AST | None]:
    """Names declared in fused_params, and the AST site declaring them."""
    names: set[str] = set()
    site: ast.AST | None = None

    def collect(value: ast.AST, at: ast.AST):
        nonlocal site
        if isinstance(value, (ast.Tuple, ast.List, ast.Set)):
            got = {
                e.value for e in value.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)
            }
            if got:
                names.update(got)
                site = site or at

    for node in ast.walk(cls):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if (
                    isinstance(tgt, ast.Name) and tgt.id == "fused_params"
                ) or (
                    isinstance(tgt, ast.Attribute)
                    and tgt.attr == "fused_params"
                ):
                    collect(node.value, node)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            tgt = node.target
            if (
                isinstance(tgt, ast.Name) and tgt.id == "fused_params"
            ) or (
                isinstance(tgt, ast.Attribute) and tgt.attr == "fused_params"
            ):
                collect(node.value, node)
    return names, site


class FusedContractRule(Rule):
    id = "fused-contract"
    description = (
        "kernels declaring fused_params must define bind_fused; fused "
        "scalars never appear in branch tests of traced methods"
    )

    def check_file(self, ctx):
        host_funcs = set(ctx.options.get("host_functions", []))
        out: list[Violation] = []
        for node in ctx.tree.body:
            if isinstance(node, ast.ClassDef):
                out.extend(self._check_class(ctx, node, host_funcs))
        return out

    def _check_class(self, ctx, cls: ast.ClassDef, host_funcs):
        fused, site = _fused_names_of(cls)
        if not fused:
            return
        methods = {
            n.name: n for n in cls.body if isinstance(n, ast.FunctionDef)
        }
        if "bind_fused" not in methods:
            yield Violation(
                self.id, ctx.path,
                getattr(site, "lineno", cls.lineno),
                getattr(site, "col_offset", cls.col_offset),
                f"class {cls.name} declares fused_params "
                f"{sorted(fused)} but defines no bind_fused(); a fused "
                "bucket cannot rebind its per-cell values",
            )
        for name, func in methods.items():
            if name in host_funcs:
                continue
            yield from self._check_method(ctx, cls, func, fused)

    def _check_method(self, ctx, cls, func: ast.FunctionDef, fused):
        for node in ast.walk(func):
            test = None
            if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                test = node.test
            if test is None:
                continue
            hot = sorted(_mentions(test) & fused)
            if hot:
                yield Violation(
                    self.id, ctx.path, node.lineno, node.col_offset,
                    f"{cls.name}.{func.name} branches on fused scalar(s) "
                    f"{', '.join(hot)}; fused params are per-cell tensors "
                    "in a fused bucket — use mask arithmetic (torch.where)",
                )


register_rule(FusedContractRule())
