"""Plain f32 reference of the models the benchmark trains: the parts every
family shares, and the lookup of the family's layer stack.

Shared here: the leaves ``embed``, ``final_norm.gamma`` and ``head`` (untied
models), in that order and before the layers; the seeded frames (a stubbed
audio frontend) or the token embedding; the final RMSNorm (eps 1e-6), the
tied or untied head and the f32 log-softmax NLL.  The layers between the
embedding and the final norm are the family's stack: a module of
``reference/stacks/`` found by ``stacks.stack_for(model)``, whose
``FAMILIES`` holds ``model["family"]`` (the contract is in that package's
docstring).  A family with no stack module raises; none is computed as
another.

Every operation runs in f32 with TF32 off.  It imports nothing of the port:
parameters are a dict from the port's leaf paths (``layers.3.attn.wq``) to
tensors.  ``mm`` is the one matrix product every projection and every
product of a stack goes through: ``torch.matmul`` for the reference, a
quantising product for the control (``train.fp8_matmul``).
"""

from __future__ import annotations

import torch
from torch.utils import checkpoint

from .stacks import stack_for

CONV_K = 4
EPS = 1e-6
#: the Mamba2 parameters kept in f32 whatever the model dtype
SSM_F32 = ("A_log", "D", "dt_bias")


def head_dim(model: dict) -> int:
    return model.get("head_dim") or model["d_model"] // model["num_heads"]


def ssm_sizes(model: dict) -> tuple[int, int, int, int]:
    """(d_inner, d_state, heads, head_dim) of a Mamba2 block."""
    di = model.get("ssm_expand", 2) * model["d_model"]
    hd = model.get("ssm_head_dim", 64)
    return di, model["ssm_state"], di // hd, hd


def dense(path: str, d_in: int, d_out: int) -> tuple[str, tuple, str, float]:
    """The spec of a (d_in, d_out) projection: normal at scale d_in^-1/2."""
    return path, (d_in, d_out), "normal", d_in ** -0.5


def param_spec(model: dict) -> list[tuple[str, tuple, str, float]]:
    """(path, shape, init, scale) of every leaf, in a fixed order: the shared
    leaves, then the stack's (``stack_spec``).  ``init`` is ``normal`` (scale
    times a standard normal), ``ones`` or ``zeros``; a path ending in one of
    ``SSM_F32`` is kept in f32."""
    d, V = model["d_model"], model["vocab_size"]
    spec = [("embed", (V, d), "normal", 0.02), ("final_norm.gamma", (d,), "ones", 0.0)]
    if not model.get("tie_embeddings", False):
        spec.append(dense("head", d, V))
    return spec + list(stack_for(model).stack_spec(model))


def is_f32_leaf(path: str) -> bool:
    return path.rsplit(".", 1)[-1] in SSM_F32


def rmsnorm(x, gamma):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * gamma


def run_layers(block, p, model: dict, x, mm, remat: bool):
    """``x`` through ``model["num_layers"]`` layers, layer i being
    ``block(p, "layers.{i}.", x, model, mm)``, each checkpointed when
    ``remat``."""
    for i in range(model["num_layers"]):
        fn = lambda h, pre=f"layers.{i}.": block(p, pre, h, model, mm)  # noqa: E731
        x = checkpoint.checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
    return x


def sequence_nll(p, model: dict, batch: dict, mm=torch.matmul, remat: bool = True):
    """Each sequence's mean NLL (b,), in f32: next-token for a causal
    model, per frame for the encoder.  Each layer is checkpointed when
    ``remat``, so that a full-depth model's backward fits."""
    if model.get("frontend", "none") == "audio_stub":
        x = batch["frames"].float()
    else:
        x = p["embed"][batch["tokens"]]
    x = stack_for(model).stack(p, model, x, mm, remat)
    x = rmsnorm(x, p["final_norm.gamma"])
    head = p["embed"].T if model.get("tie_embeddings", False) else p["head"]
    logits = mm(x, head)
    labels = batch["labels"]
    if model.get("causal", True):
        logits, labels = logits[:, :-1], labels[:, 1:]
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[..., None].long())[..., 0].mean(dim=1)
