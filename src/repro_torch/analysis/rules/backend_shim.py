"""``backend-shim`` — kernel round code stays in torch on the kernel's device.

The JAX package routes every kernel array op through its ``core.backend``
shim so one code runs on numpy and staged under ``jax.jit``.  The port's
counterpart of that discipline: the lockstep kernels (``core/kernel.py``)
hold every per-cell array as a torch tensor on the kernel's device (the card
unless the caller asks for the CPU), and a round's ops stay there.  A raw
``np.*`` call in a kernel body computes on the host: on the card it either
reads a tensor back (a hidden transfer and sync every round) or mixes a host
array into device math; on the CPU it hides the bug until the card runs.

Checks in scoped files:

* module-level ``import jax`` / ``import jax.numpy`` — the port never
  imports JAX;
* calls through a raw array-namespace alias (``np.*``, ``numpy.*``,
  ``jnp.*``) inside function bodies, except in host-side functions named by
  ``allow_functions`` (constructors and ``fused_scalars``, which read a
  spec's prototype on the host) and callees in ``allow_calls``.

Non-call attribute access (``np.ndarray`` annotations, ``np.int64`` dtype
literals, ``np.inf``) is fine: dtypes and annotations are not array ops.
"""

from __future__ import annotations

import ast

from ..astutil import dotted_name, iter_functions
from ..engine import Rule, Violation, register_rule

_RAW_ALIASES = ("np", "jnp", "numpy", "onp")


class BackendShimRule(Rule):
    id = "backend-shim"
    description = (
        "kernel modules compute per-cell arrays in torch on the kernel's "
        "device, never raw np/jnp, and never import jax"
    )

    def check_file(self, ctx):
        allow_funcs = set(ctx.options.get("allow_functions", []))
        allow_calls = set(ctx.options.get("allow_calls", []))
        out: list[Violation] = []

        for node in ctx.tree.body:
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            for mod in mods:
                if mod == "jax" or mod.startswith("jax."):
                    out.append(Violation(
                        self.id, ctx.path, node.lineno, node.col_offset,
                        f"module-level import of {mod!r} in a kernel "
                        "module: the port never imports jax",
                    ))

        # nodes inside host-side allow-listed functions are exempt
        allowed_nodes: set[int] = set()
        for func, _cls in iter_functions(ctx.tree):
            if func.name in allow_funcs:
                for node in ast.walk(func):
                    allowed_nodes.add(id(node))

        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or id(node) in allowed_nodes:
                continue
            name = dotted_name(node.func)
            if name is None:
                continue
            root, _, _rest = name.partition(".")
            if root in _RAW_ALIASES and "." in name and name not in allow_calls:
                out.append(Violation(
                    self.id, ctx.path, node.lineno, node.col_offset,
                    f"raw {name}() in kernel code computes on the host; "
                    "use torch ops on the kernel's device",
                ))
        return out


register_rule(BackendShimRule())
