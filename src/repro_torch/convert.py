"""Weights bridge from the JAX package.

``params_from_jax`` takes the JAX package's parameter pytree, converted to
numpy arrays (``jax.tree.map(np.asarray, params)``), and returns the port's
parameters.  Both packages keep dense weights as (d_in, d_out) applied as
``x @ w``, so no weight is transposed; the stacked ``layers`` arrays (L, ...)
are split into one dict per layer, and a tied head stays ``embed.T``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import torch_dtype


def _tensor(a, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype
    )


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def params_from_jax(tree: dict, cfg: ModelConfig, device="cuda", dtype=None) -> dict:
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.family} weights are not ported yet; see ROADMAP.md A-8")
    dtype = dtype or torch_dtype(cfg)

    def conv(a):
        return _tensor(a, device, dtype)

    params = _map({k: v for k, v in tree.items() if k != "layers"}, conv)
    params["layers"] = [
        _map(tree["layers"], lambda a, i=i: conv(np.asarray(a)[i]))
        for i in range(cfg.num_layers)
    ]
    return params
