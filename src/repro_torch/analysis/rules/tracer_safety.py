"""``tracer-safety`` — a round's kernel and gate bodies never read a tensor
back to the host.

The JAX package's rule keeps staged (jit/scan/vmap) kernel bodies from
branching on tracers.  The port runs its kernels eagerly, but on the card:
the contract of ``core/kernel.py`` is that ``step`` "never reads a tensor
back to the host", and the gate reads one only where it must decide whether
a round has anything to wait out.  Every such read stalls the host on the
device once a round, for every cell of a grid-fused bucket.  Findings, within
functions named by ``staged_functions`` (config):

* ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` anywhere — a host
  read by definition;
* ``bool()`` / ``int()`` / ``float()`` on a value reachable from per-cell
  data;
* ``if`` / ``while`` / ternary / ``assert`` tests on such a value (Python
  calls ``__bool__``, a host read).

Mechanics: parameters named by ``traced_params`` seed a taint set; taint
propagates through assignments to names (an in-place update of a tensor's
subscript taints none of its index names); the parameters of a nested closure
(a per-iteration check) are tainted too.  Identity tests (``x is None``)
never call ``__bool__``; names under shape metadata (``x.shape``) are host
values.  The gate's sanctioned checks — the ones ``GateKernel.host_syncs``
counts — carry an ``allow[tracer-safety]`` pragma stating so.
"""

from __future__ import annotations

import ast

from ..astutil import func_param_names, is_identity_test, names_in
from ..engine import Rule, Violation, register_rule

_HOST_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
_CAST_FUNCS = ("bool", "int", "float")


def _bound_names(targets) -> list[str]:
    """Names an assignment binds: plain names, through tuple / list /
    starred unpacking.  An in-place update of a subscript or attribute
    (``state.pend[:, sl, :, j] |= stragglers``, the port's idiom) binds
    nothing: its index names stay host values."""
    out: list[str] = []
    for t in targets:
        if isinstance(t, ast.Name):
            out.append(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            out += _bound_names(t.elts)
        elif isinstance(t, ast.Starred):
            out += _bound_names([t.value])
    return out


class TracerSafetyRule(Rule):
    id = "tracer-safety"
    description = (
        "a round's kernel/gate bodies must not branch on, cast or copy to "
        "the host a value reachable from per-cell tensors"
    )

    def check_file(self, ctx):
        staged = set(ctx.options.get("staged_functions", []))
        traced_params = set(ctx.options.get("traced_params", []))
        out: list[Violation] = []
        for node in ctx.tree.body:
            self._visit(node, staged, traced_params, ctx, out)
        return out

    def _visit(self, node, staged, traced_params, ctx, out):
        if isinstance(node, ast.FunctionDef) and node.name in staged:
            out.extend(self._check_staged(ctx, node, traced_params))
            return
        for child in ast.iter_child_nodes(node):
            self._visit(child, staged, traced_params, ctx, out)

    # -- one staged function ---------------------------------------------
    def _check_staged(self, ctx, func: ast.FunctionDef, traced_params):
        tainted = {p for p in func_param_names(func) if p in traced_params}
        tainted |= self._propagate(func, tainted)
        out: list[Violation] = []

        def check(node: ast.AST, owner, taint):
            out.extend(self._check_node(ctx, owner, node, taint))
            if isinstance(node, ast.FunctionDef) and node is not owner:
                # nested closure (a per-iteration check): its parameters
                # carry per-cell tensors
                inner = set(func_param_names(node)) | taint
                inner |= self._propagate(node, inner)
                for child in ast.iter_child_nodes(node):
                    check(child, node, inner)
                return
            for child in ast.iter_child_nodes(node):
                check(child, owner, taint)

        for stmt in func.body:
            check(stmt, func, tainted)
        return out

    def _propagate(self, func: ast.FunctionDef, seed: set[str]) -> set[str]:
        """Forward taint through simple assignments, to fixpoint."""
        tainted = set(seed)
        for _ in range(4):
            grew = False
            for node in ast.walk(func):
                targets = []
                value = None
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    targets, value = [node.target], node.value
                elif isinstance(node, ast.NamedExpr):
                    targets, value = [node.target], node.value
                if value is None:
                    continue
                if names_in(value) & tainted:
                    for n in _bound_names(targets):
                        if n not in tainted:
                            tainted.add(n)
                            grew = True
            if not grew:
                break
        return tainted

    def _check_node(self, ctx, func, node, tainted):
        test = None
        what = None
        if isinstance(node, (ast.If, ast.While)):
            test, what = node.test, type(node).__name__.lower()
        elif isinstance(node, ast.IfExp):
            test, what = node.test, "conditional expression"
        elif isinstance(node, ast.Assert):
            test, what = node.test, "assert"
        if test is not None:
            if is_identity_test(test):
                return
            hot = sorted(names_in(test) & tainted)
            if hot:
                yield Violation(
                    self.id, ctx.path, node.lineno, node.col_offset,
                    f"`{what}` in `{func.name}` branches on per-cell "
                    f"value(s) {', '.join(hot)}, a host read each round; "
                    "use mask-select math (torch.where)",
                )
            return
        if isinstance(node, ast.Call):
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _HOST_SYNC_METHODS
            ):
                yield Violation(
                    self.id, ctx.path, node.lineno, node.col_offset,
                    f".{node.func.attr}() in `{func.name}` reads a tensor "
                    "back to the host",
                )
                return
            if (
                isinstance(node.func, ast.Name)
                and node.func.id in _CAST_FUNCS
                and any(names_in(a) & tainted for a in node.args)
            ):
                yield Violation(
                    self.id, ctx.path, node.lineno, node.col_offset,
                    f"{node.func.id}() on a per-cell value in `{func.name}` "
                    "reads it back to the host",
                )


register_rule(TracerSafetyRule())
