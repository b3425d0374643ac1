"""State bridge from the JAX package.

Each converter takes a JAX package pytree converted to numpy arrays
(``jax.tree.map(np.asarray, tree)``) and returns the port's counterpart:

* ``params_from_jax``: a model's parameters.  Both packages keep dense
  weights as (d_in, d_out) applied as ``x @ w``, so no weight is
  transposed; the stacked ``layers`` arrays (L, ...) are split into one
  dict per layer (a moe layer's ``moe`` with its nested ``shared`` experts
  included), the hybrid's ``shared_attn`` (one block, not stacked) stays one
  dict, and a tied head stays ``embed.T``.  Leaves are cast to the
  model dtype, but for those the JAX package keeps in f32 whatever the model
  dtype (the ssm block's ``A_log``, ``D`` and ``dt_bias``).
* ``mlp_params_from_jax``: the coded-training driver's ``MLPModel``
  parameters (a flat dict, f32).
* ``adamw_state_from_jax``: an ``AdamWState``, its f32 moments laid out as
  the parameters they belong to.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.ssm import F32_PARAMS
from repro_torch.models.transformer import _check_family, torch_dtype
from repro_torch.optim import AdamWState


def _tensor(a, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype
    )


def _map(tree, fn, path=()):
    """The tree with each leaf ``a`` at key path ``p`` replaced by ``fn(p, a)``."""
    return {k: _map(v, fn, path + (k,)) if isinstance(v, dict) else fn(path + (k,), v)
            for k, v in tree.items()}


def params_from_jax(tree: dict, cfg: ModelConfig, device="cuda", dtype=None) -> dict:
    _check_family(cfg)
    dtype = dtype or torch_dtype(cfg)

    def conv(path, a):
        f32 = len(path) >= 2 and path[-2] == "ssm" and path[-1] in F32_PARAMS
        return _tensor(a, device, torch.float32 if f32 else dtype)

    params = _map({k: v for k, v in tree.items() if k != "layers"}, conv)
    params["layers"] = [
        _map(tree["layers"], lambda path, a, i=i: conv(path, np.asarray(a)[i]))
        for i in range(cfg.num_layers)
    ]
    return params


def mlp_params_from_jax(tree: dict, device="cuda") -> dict:
    return _map(tree, lambda _, a: _tensor(a, device, torch.float32))


def adamw_state_from_jax(state, cfg: ModelConfig, device="cuda") -> AdamWState:
    """The AdamW state of a model of ``cfg``; its moments stay f32."""

    def conv(t):
        return params_from_jax(t, cfg, device, torch.float32)

    return AdamWState(step=int(np.asarray(state.step)), m=conv(state.m), v=conv(state.v))
