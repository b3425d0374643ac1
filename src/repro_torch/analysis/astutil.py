"""Shared AST helpers for the contract rules.

Port of ``repro.analysis.astutil``.  The JAX package's kernels run one code
both eagerly and staged, and its helpers recognize the ``concrete``-flag
idioms that mark eager-only regions; the port's kernels have one path, on
the device, so those idioms have no counterpart here and every statement of
a kernel body is checked.
"""

from __future__ import annotations

import ast
from typing import Iterator

#: attribute accesses that are static metadata (shapes); names underneath
#: them never carry tensor *values* into a test.
STATIC_ATTRS = frozenset({"shape", "ndim", "dtype"})


def iter_functions(tree: ast.AST) -> Iterator[tuple[ast.AST, str | None]]:
    """Every (function node, enclosing class name) in ``tree``."""

    def walk(node: ast.AST, cls: str | None):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from walk(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield child, cls
                yield from walk(child, cls)
            else:
                yield from walk(child, cls)

    yield from walk(tree, None)


def func_param_names(func: ast.FunctionDef) -> list[str]:
    a = func.args
    params = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        params.append(a.vararg.arg)
    if a.kwarg:
        params.append(a.kwarg.arg)
    return params


def names_in(node: ast.AST, *, skip_static_attrs: bool = True) -> set[str]:
    """Free names loaded in ``node``; subtrees under shape-metadata
    attributes (``x.shape`` etc.) are pruned when requested, since those are
    host values."""
    out: set[str] = set()

    def walk(n: ast.AST):
        if (
            skip_static_attrs
            and isinstance(n, ast.Attribute)
            and n.attr in STATIC_ATTRS
        ):
            return
        if isinstance(n, ast.Name):
            out.add(n.id)
        for child in ast.iter_child_nodes(n):
            walk(child)

    walk(node)
    return out


def is_identity_test(test: ast.AST) -> bool:
    """Tests built purely from ``is`` / ``is not`` comparisons (and boolean
    combinations / negations of them) never call ``__bool__`` on a tensor
    operand — the ``d2 is None`` sentinel idiom."""
    if isinstance(test, ast.Compare):
        return all(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops)
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return is_identity_test(test.operand)
    if isinstance(test, ast.BoolOp):
        return all(is_identity_test(v) for v in test.values)
    return False


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` as a string for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None
