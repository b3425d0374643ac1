"""Model assembly of the dense family (GQA attention + SwiGLU, optional QKV
bias / sliding window / tied embeddings) and the ssm family (Mamba2 blocks
only, attention-free).

Port of ``src/repro/models/transformer.py``.  Parameters are a plain dict:
``embed`` (vocab, d), ``final_norm``, optional ``head`` (d, vocab), and
``layers``, a list with one dict per layer (the JAX package stacks layers on
a leading axis and scans them; here the scan is a Python loop).  The serve
path (``prefill``, ``decode_step``, ``generate``) runs under
``torch.inference_mode`` and updates the cache in place: a KV cache for the
dense family, the SSM state and conv buffer for the ssm family.

Every entry point takes ``plain=False``; ``plain=True`` runs the plain
PyTorch versions of the kernels on any device.  ``forward``, ``token_nll``
and ``loss_fn`` run under autograd: on the card, the kernels' backward
kernels differentiate them (the dense family; the ``ssd_scan`` kernel has no
backward, so the ssm family trains on the CPU only for now).
"""

from __future__ import annotations

import torch

from . import ssm as ssm_mod
from .config import ModelConfig
from .layers import (
    attention_apply,
    attention_decode,
    attention_init,
    mlp_apply,
    mlp_init,
    rmsnorm_apply,
    rmsnorm_init,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "ssm") or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported to repro_torch yet; "
            f"see ROADMAP.md A-8"
        )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters drawn from ``gen``, on ``gen.device``, in ``cfg.dtype``.

    Draws are made in f32 and then cast, so one seed gives the same weights,
    rounded, in every dtype.
    """
    _check_family(cfg)
    dtype, device = torch_dtype(cfg), gen.device
    embed = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen, device=device) * 0.02
    params: dict = {
        "embed": embed.to(dtype),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = (
            torch.randn((cfg.d_model, cfg.vocab_size), generator=gen, device=device)
            * cfg.d_model ** -0.5
        ).to(dtype)
    if cfg.family == "ssm":
        params["layers"] = [
            {
                "norm1": rmsnorm_init(cfg.d_model, dtype, device),
                "ssm": ssm_mod.ssm_init(gen, cfg, dtype),
            }
            for _ in range(cfg.num_layers)
        ]
        return params
    params["layers"] = [
        {
            "norm1": rmsnorm_init(cfg.d_model, dtype, device),
            "attn": attention_init(gen, cfg, dtype),
            "norm2": rmsnorm_init(cfg.d_model, dtype, device),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype),
        }
        for _ in range(cfg.num_layers)
    ]
    return params


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------


def embed_inputs(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """(b, s, d) input sequence from batch["tokens"] (b, s)."""
    _check_family(cfg)
    return params["embed"][batch["tokens"]]


def _head(params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def _layer(lp, cfg, x, *, plain):
    h, (k, v) = attention_apply(lp["attn"], rmsnorm_apply(lp["norm1"], x, plain=plain),
                                cfg, plain=plain)
    x = x + h
    x = x + mlp_apply(lp["mlp"], rmsnorm_apply(lp["norm2"], x, plain=plain))
    return x, k, v


def _ssm_layer(lp, cfg, x, *, plain, return_cache=False):
    """x + ssm(norm1(x)); with ``return_cache`` also (state, conv_buf)."""
    out = ssm_mod.ssm_apply(lp["ssm"], rmsnorm_apply(lp["norm1"], x, plain=plain), cfg,
                            return_cache=return_cache, plain=plain)
    if return_cache:
        y, state, conv = out
        return x + y, state, conv
    return x + out


def forward(params, cfg: ModelConfig, batch, *, plain: bool = False):
    """Full-sequence logits. Returns (logits (b, s, vocab), aux_loss)."""
    x = embed_inputs(params, cfg, batch)
    for lp in params["layers"]:
        if cfg.family == "ssm":
            x = _ssm_layer(lp, cfg, x, plain=plain)
        else:
            x, _, _ = _layer(lp, cfg, x, plain=plain)
    x = rmsnorm_apply(params["final_norm"], x, plain=plain)
    return x @ _head(params, cfg), torch.zeros((), device=x.device)


def token_nll(params, cfg: ModelConfig, batch, *, plain: bool = False):
    """(per-token f32 NLL, aux): next-token (b, s-1) for causal LMs, (b, s)
    otherwise.  Log-softmax in f32 whatever the model dtype."""
    logits, aux = forward(params, cfg, batch, plain=plain)
    labels = batch["labels"]
    if cfg.causal:
        logits, labels = logits[:, :-1], labels[:, 1:]
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None].long())[..., 0], aux


def loss_fn(params, cfg: ModelConfig, batch, *, aux_weight: float = 0.01,
            plain: bool = False):
    """Mean CE (next-token for causal LMs, per-frame for encoders)."""
    nll, aux = token_nll(params, cfg, batch, plain=plain)
    return nll.mean() + aux_weight * aux


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode step
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, dtype=None, device=None):
    """The decode cache, stacked on a leading layer axis.

    dense: KV cache k, v (L, b, hkv, max_seq, dh).  ssm: ``state`` (L, b, nh,
    hd, st) f32 and ``conv`` (L, b, 3, conv_dim) in the model dtype, whatever
    ``max_seq``.
    """
    _check_family(cfg)
    dtype = dtype or torch_dtype(cfg)
    if cfg.family == "ssm":
        conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_state
        L = cfg.num_layers
        return {
            "state": torch.zeros((L, batch_size, cfg.ssm_heads, cfg.ssm_head_dim,
                                  cfg.ssm_state), dtype=torch.float32, device=device),
            "conv": torch.zeros((L, batch_size, ssm_mod.CONV_K - 1, conv_dim), dtype=dtype,
                                device=device),
        }
    shape = (cfg.num_layers, batch_size, cfg.num_kv_heads, max_seq, cfg.head_dim_)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


@torch.inference_mode()
def prefill(params, cfg: ModelConfig, batch, max_seq: int, *, plain: bool = False):
    """Process a prompt batch and build the decode cache.

    Returns (logits (b, s, vocab), cache) with the cache holding ``max_seq``
    positions, ready for ``decode_step`` at pos = s.
    """
    x = embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    if s > max_seq:
        raise ValueError(f"prompt length {s} exceeds max_seq {max_seq}")
    cache = init_cache(cfg, b, max_seq, dtype=x.dtype, device=x.device)
    for i, lp in enumerate(params["layers"]):
        if cfg.family == "ssm":
            x, cache["state"][i], cache["conv"][i] = _ssm_layer(lp, cfg, x, plain=plain,
                                                                return_cache=True)
            continue
        x, k, v = _layer(lp, cfg, x, plain=plain)
        cache["k"][i, :, :, :s] = k
        cache["v"][i, :, :, :s] = v
    x = rmsnorm_apply(params["final_norm"], x, plain=plain)
    return x @ _head(params, cfg), cache


@torch.inference_mode()
def decode_step(params, cfg: ModelConfig, cache, token, pos: int, *, plain: bool = False):
    """One serve step: token (b, 1) int, pos the token's position.

    Returns (logits (b, vocab), cache); the cache is updated in place.  The
    ssm family's state carries the position, so ``pos`` is not read there.
    """
    _check_family(cfg)
    x = params["embed"][token]
    if cfg.family == "ssm":
        for i, lp in enumerate(params["layers"]):
            y, cache["state"][i], cache["conv"][i] = ssm_mod.ssm_decode_step(
                lp["ssm"], rmsnorm_apply(lp["norm1"], x, plain=plain), cache["state"][i],
                cache["conv"][i], cfg, plain=plain)
            x = x + y
    else:
        if not 0 <= pos < cache["k"].shape[3]:
            raise ValueError(f"pos {pos} outside the cache's {cache['k'].shape[3]} positions")
        for i, lp in enumerate(params["layers"]):
            h = attention_decode(lp["attn"], rmsnorm_apply(lp["norm1"], x, plain=plain),
                                 cache["k"][i], cache["v"][i], pos, cfg)
            x = x + h
            x = x + mlp_apply(lp["mlp"], rmsnorm_apply(lp["norm2"], x, plain=plain))
    x = rmsnorm_apply(params["final_norm"], x, plain=plain)
    return (x @ _head(params, cfg))[:, 0], cache


@torch.inference_mode()
def generate(params, cfg: ModelConfig, batch, *, num_tokens: int,
             max_seq: int | None = None, plain: bool = False) -> torch.Tensor:
    """Greedy generation: prefill the prompt, then decode step by step.

    batch: {"tokens": (b, s)} prompt.  Returns (b, num_tokens) int32.
    """
    s = batch["tokens"].shape[1]
    max_seq = max_seq or (s + num_tokens)
    logits, cache = prefill(params, cfg, batch, max_seq, plain=plain)
    token = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
    out = [token]
    for i in range(num_tokens - 1):
        logits, cache = decode_step(params, cfg, cache, token, s + i, plain=plain)
        token = logits.argmax(dim=-1)[:, None].to(torch.int32)
        out.append(token)
    return torch.cat(out, dim=1)
