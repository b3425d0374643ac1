"""The reference's layer stacks, one module a model family, found by the
model's ``family`` as the metric readers are found by their names.

Each module of this directory declares ``FAMILIES``, the ``family`` values it
serves, and holds its stack's own parts:

* ``stack_spec(model)``: (path, shape, init, scale) of its layer leaves, in a
  fixed order.  ``model.param_spec`` puts them after the shared leaves, and
  ``weights.make_weights`` slices one draw by that order, so a reordered spec
  changes every weight.
* ``stack(p, model, x, mm, remat)``: the embedded input to the hidden state
  before the final norm.  Every product goes through ``mm``, and each layer is
  checkpointed when ``remat``.  The whole stack is one call, so a stack that
  carries its input beside the hidden state fits the same contract.
* ``stack_ops(model, seq)``: the operations of one sequence of ``seq``
  positions through the stack, counted as ``flops`` counts, the head left out.
* ``launches_per_step(model)``: the port's kernel launches of one coded step,
  as ``flops.step_launches`` makes them.

A configuration of a new family brings a new module here, and nothing else of
the reference or the yardstick changes.
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

#: where ``stack_for`` looks for the stack modules
DIR = Path(__file__).resolve().parent


@functools.cache
def _modules(directory: Path) -> tuple:
    """Each module of ``directory`` (its ``*.py`` but ``__init__.py``), imported
    once, in the order of their names."""
    found = []
    for path in sorted(directory.glob("*.py")):
        if path.name == "__init__.py":
            continue
        spec = importlib.util.spec_from_file_location(f"{__name__}.{path.stem}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        found.append(module)
    return tuple(found)


def stack_for(model: dict):
    """The stack module whose ``FAMILIES`` holds ``model["family"]``.  Raises
    ``NotImplementedError`` where no module serves the family and
    ``ValueError`` where more than one claims it."""
    family = model["family"]
    claims = [m for m in _modules(DIR) if family in m.FAMILIES]
    if not claims:
        raise NotImplementedError(f"no reference stack for the {family!r} family: no module "
                                  f"of {DIR} lists it in its FAMILIES")
    if len(claims) > 1:
        names = ", ".join(Path(m.__file__).name for m in claims)
        raise ValueError(f"the {family!r} family is claimed by {names}, all in {DIR}")
    return claims[0]
