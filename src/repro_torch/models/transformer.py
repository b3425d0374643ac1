"""Model assembly of six families:

  dense  -- GQA attention + SwiGLU, optional QKV bias / sliding window /
            tied embeddings;
  moe    -- the dense family's attention + a grouped top-K mixture of experts
            (optionally with shared experts) in place of the SwiGLU, whose
            load-balance aux loss ``forward`` sums over the layers;
  ssm    -- Mamba2 blocks only (attention-free);
  hybrid -- zamba2-style: the Mamba2 stack with ONE shared (weight-tied)
            attention + MLP block applied after every ``attn_every`` of its
            layers;
  vlm    -- the dense decoder over [patch embeddings | text tokens]: the
            batch's ``prefix_embeds`` (the stubbed vision tower's output) come
            before the token embeddings, and the loss covers the text only;
  audio  -- a non-causal encoder over the batch's precomputed ``frames`` (the
            stubbed feature extractor's output), with a per-frame loss and no
            decode step.

Port of ``src/repro/models/transformer.py``.  Parameters are a plain dict:
``embed`` (vocab, d), ``final_norm``, optional ``head`` (d, vocab),
``layers``, a list with one dict per layer (the JAX package stacks layers on
a leading axis and scans them; here the scan is a Python loop), and for the
hybrid ``shared_attn``, the one block's weights.  The serve path
(``prefill``, ``decode_step``, ``generate``) runs under
``torch.inference_mode`` and updates the cache in place: a KV cache for the
dense, moe and vlm families; the SSM state and conv buffer for the ssm
family; both for the hybrid, whose KV cache holds one slot per call of the
shared block.

Every entry point takes ``plain=False``; ``plain=True`` runs the plain
PyTorch versions of the kernels on any device.  ``forward``, ``token_nll``
and ``loss_fn`` run under autograd, each layer body under activation
checkpointing as ``cfg.remat`` / ``cfg.remat_policy`` ask (``_remat``).  On
the card, the kernels' backward kernels differentiate them: the dense, moe,
ssm, hybrid and vlm families (the fused ``ssd_scan`` entry's backward is
``csrc/ssd_scan_bwd.cu``; the vlm's attention backward runs at head dim
256).  The audio family's gradient runs too, but its training on the card
waits for the attention backward's redesign at head dim 80 over more than
one key tile (ROADMAP B-4).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.dtensor import is_dtensor, local_shards, placements, vocab_nll
from repro_torch.tracing import span

from . import ssm as ssm_mod
from .config import ModelConfig
from .layers import (
    attention_apply,
    attention_decode,
    attention_init,
    init_device,
    mlp_apply,
    mlp_init,
    moe_apply,
    moe_init,
    recompute_routes,
    rmsnorm_apply,
    rmsnorm_init,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# the JAX package's families and input frontends
_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
_FRONTENDS = ("none", "vision_stub", "audio_stub")
# families whose every layer is an attention block
_ATTN_FAMILIES = ("dense", "moe", "vlm", "audio")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES or cfg.frontend not in _FRONTENDS:
        raise ValueError(
            f"{cfg.name}: family {cfg.family!r} with frontend {cfg.frontend!r} is in neither "
            f"package; the families are {_FAMILIES} and the frontends {_FRONTENDS}"
        )


def _shared_every(cfg: ModelConfig) -> int:
    """The hybrid's group size: its shared block runs after every that many
    Mamba2 layers; 0 where no shared block runs (the ssm family, or a hybrid
    with ``attn_every`` 0, which the JAX package runs as a plain ssm stack)."""
    k = cfg.attn_every if cfg.family == "hybrid" else 0
    if k and cfg.num_layers % k:
        raise ValueError(f"{cfg.name}: num_layers {cfg.num_layers} is not a multiple of "
                         f"attn_every {k}, so the layers do not split into groups")
    return k


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, gen: torch.Generator | None) -> dict:
    """Random parameters drawn from ``gen``, on ``gen.device``, in ``cfg.dtype``.

    Draws are made in f32 and then cast, so one seed gives the same weights,
    rounded, in every dtype.  ``gen=None`` gives meta tensors of the same
    shapes and dtypes and no storage (the JAX package's
    ``jax.eval_shape(init_params)``), at any size.
    """
    _check_family(cfg)
    dtype, device = torch_dtype(cfg), init_device(gen)
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
    if cfg.family in _ATTN_FAMILIES:
        params["layers"] = [_attn_block_init(gen, cfg, dtype) for _ in range(cfg.num_layers)]
        return params
    params["layers"] = [
        {
            "norm1": rmsnorm_init(cfg.d_model, dtype, device),
            "ssm": ssm_mod.ssm_init(gen, cfg, dtype),
        }
        for _ in range(cfg.num_layers)
    ]
    if cfg.family == "hybrid":
        params["shared_attn"] = _attn_block_init(gen, cfg, dtype)
    return params


def _attn_block_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    """One attention block: a dense layer or the hybrid's shared block, with a
    SwiGLU MLP, or a moe layer, with ``moe`` in its place."""
    p = {
        "norm1": rmsnorm_init(cfg.d_model, dtype, init_device(gen)),
        "attn": attention_init(gen, cfg, dtype),
        "norm2": rmsnorm_init(cfg.d_model, dtype, init_device(gen)),
    }
    if cfg.family == "moe":
        p["moe"] = moe_init(gen, cfg, dtype)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)
    return p


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------


def _embed(embed, tokens):
    """embed[tokens]; on DTensors each rank looks its own tokens up in the
    gathered table (``local_shards``): DTensor's rule for the lookup's
    backward (an accumulating ``index_put``) fails in some torch versions."""
    if is_dtensor(tokens):
        return local_shards(lambda t, e: e[t], [tokens], (0,), [embed])
    return embed[tokens]


def embed_inputs(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """The (b, s, d) input sequence of the batch dict.

    dense/moe/ssm/hybrid: batch["tokens"] (b, s);
    vlm:   cat(batch["prefix_embeds"] (b, P, d), embed(tokens)), s = P + text;
    audio: batch["frames"] (b, s, d), the stubbed feature extractor's output.
    """
    _check_family(cfg)
    if cfg.frontend == "audio_stub":
        return batch["frames"].to(torch_dtype(cfg))
    tok_embeds = _embed(params["embed"], batch["tokens"])
    if cfg.frontend == "vision_stub":
        prefix = batch["prefix_embeds"].to(tok_embeds.dtype)
        return torch.cat([prefix, tok_embeds], dim=1)
    return tok_embeds


def _head(params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def _ffn(lp, cfg, x, *, layer=0, segment=None):
    """The block's feed-forward on x: (out, aux), aux None for the SwiGLU MLP.
    A moe layer takes its capacity groups within segments of ``segment``
    tokens (``moe_apply``; None: the whole batch) and is logged as ``layer``."""
    if cfg.family == "moe":
        return moe_apply(lp["moe"], x, cfg, segment=segment, layer=layer)
    return mlp_apply(lp["mlp"], x), None


def _act_constraint(x, cfg: ModelConfig):
    """The JAX package's FSDP / sequence-parallel pin: hidden states (b, s, ...)
    sharded on the batch over ``cfg.act_batch_axes`` and on the sequence over
    ``cfg.act_seq_axis``, every other dimension whole, so that the (sharded)
    parameters are gathered per layer rather than the activations summed.  A
    DTensor is redistributed to that layout; a plain tensor, or a config that
    sets neither field, passes through."""
    if not (cfg.act_batch_axes or cfg.act_seq_axis) or not is_dtensor(x):
        return x
    mesh = x.device_mesh
    spec = (tuple(cfg.act_batch_axes) or None, cfg.act_seq_axis or None)
    return x.redistribute(mesh, placements(mesh, spec))


def _whole_seq(x, cfg: ModelConfig):
    """Under sequence parallelism (``cfg.act_seq_axis``), a DTensor's sequence
    gathered before the products that take it (Megatron's all-gather before
    the column-parallel ones): some torch versions cannot fold a sequence
    sharded beside a sharded batch into a product's rows.  Otherwise x."""
    if not cfg.act_seq_axis or not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, placements(x.device_mesh,
                                                    (tuple(cfg.act_batch_axes) or None,)))


def _layer(lp, cfg, x, *, plain, layer=0, segment=None):
    """One attention block: (x, aux, k, v); its attention and its
    feed-forward, each with its norm and residual, in the spans
    ``model.attention`` and ``model.mlp``."""
    with span("model.attention"):
        x = _act_constraint(x, cfg)
        h, (k, v) = attention_apply(
            lp["attn"], _whole_seq(rmsnorm_apply(lp["norm1"], x, plain=plain), cfg), cfg,
            plain=plain)
        x = x + _act_constraint(h, cfg)
    with span("model.mlp"):
        h, aux = _ffn(lp, cfg, _whole_seq(rmsnorm_apply(lp["norm2"], x, plain=plain), cfg),
                      layer=layer, segment=segment)
        return x + _act_constraint(h, cfg), aux, k, v


def _ssm_layer(lp, cfg, x, *, plain, return_cache=False):
    """x + ssm(norm1(x)), in the span ``model.ssm``; with ``return_cache``
    also (state, conv_buf)."""
    with span("model.ssm"):
        x = _act_constraint(x, cfg)
        out = ssm_mod.ssm_apply(lp["ssm"], _whole_seq(rmsnorm_apply(lp["norm1"], x,
                                                                    plain=plain), cfg), cfg,
                                return_cache=return_cache, plain=plain)
        if return_cache:
            y, state, conv = out
            return x + _act_constraint(y, cfg), state, conv
        return x + _act_constraint(out, cfg)


# the products whose outputs the "dots" policy keeps (``x @ w`` and the plain
# attention's einsums reach these below autograd); everything else is recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS else \
        ckpt.CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _entered_together(*contexts):
    with contextlib.ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        yield


def _remat(fn, cfg: ModelConfig):
    """fn under activation checkpointing, as the JAX package's ``_remat``
    wraps a layer body in ``jax.checkpoint``: nothing of its inside is kept
    for the backward ("full"), or only its matrix products' outputs
    ("dots", ``checkpoint_dots``), and the rest runs again in the backward.
    ``remat=False`` or policy "none" keeps fn as it is, and so does a call
    with gradients off (prefill and decode, which run under inference mode).
    The layer bodies draw no random numbers, so no RNG state is kept.  The
    recompute runs under the forward's route log, so a moe layer takes the
    experts its forward chose (``layers.recompute_routes``)."""
    if not cfg.remat or cfg.remat_policy == "none":
        return fn
    dots = cfg.remat_policy == "dots"

    def context_fn():
        fwd, again = (ckpt.create_selective_checkpoint_contexts(_dots_policy) if dots
                      else ckpt.noop_context_fn())
        return fwd, _entered_together(again, recompute_routes())

    def wrapped(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        return ckpt.checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                               context_fn=context_fn, **kwargs)

    return wrapped


def _stack_forward(params, cfg: ModelConfig, x, *, plain, segment=None):
    """The layer stack: attention blocks, or Mamba2 layers with the hybrid's
    shared block after each group of ``attn_every``.  Returns (x, the sum of
    the moe layers' aux losses, or None).  ``segment``: see ``forward``."""
    if cfg.family in _ATTN_FAMILIES:
        body = _remat(lambda lp, h, i: _layer(lp, cfg, h, plain=plain, layer=i,
                                              segment=segment)[:2], cfg)
        total = None
        for i, lp in enumerate(params["layers"]):
            x, aux = body(lp, x, i)
            if aux is not None:
                total = aux if total is None else total + aux
        return x, total
    every = _shared_every(cfg)
    ssm_body = _remat(lambda lp, h: _ssm_layer(lp, cfg, h, plain=plain), cfg)
    attn_body = _remat(lambda lp, h: _layer(lp, cfg, h, plain=plain)[0], cfg)
    for i, lp in enumerate(params["layers"]):
        x = ssm_body(lp, x)
        if every and (i + 1) % every == 0:
            x = attn_body(params["shared_attn"], x)
    return x, None


def forward(params, cfg: ModelConfig, batch, *, plain: bool = False,
            segment: int | None = None):
    """Full-sequence logits. Returns (logits (b, s, vocab), aux_loss).

    ``segment``: the tokens of one independent segment of the batch (a coded
    chunk's sequences, consecutive in the batch), within which a moe layer
    takes its capacity groups (``layers.moe_apply``); None, the whole batch.
    Other families do not read it.  The final norm and the head product run
    in the span ``model.head``."""
    x, aux = _stack_forward(params, cfg, embed_inputs(params, cfg, batch), plain=plain,
                            segment=segment)
    with span("model.head"):
        x = _whole_seq(rmsnorm_apply(params["final_norm"], x, plain=plain), cfg)
        logits = x @ _head(params, cfg)
    return logits, torch.zeros((), device=x.device) if aux is None else aux


def token_nll(params, cfg: ModelConfig, batch, *, plain: bool = False,
              segment: int | None = None):
    """(per-token f32 NLL, aux): next-token (b, s-1) for causal LMs, (b, s)
    otherwise; a vlm's labels cover its text only, so its NLL is the last
    text - 1 positions'.  Log-softmax in f32 whatever the model dtype, in the
    span ``model.head``.  ``segment``: see ``forward``."""
    logits, aux = forward(params, cfg, batch, plain=plain, segment=segment)
    with span("model.head"):
        labels = batch["labels"]
        if cfg.causal:
            logits, labels = logits[:, :-1], labels[:, 1:]
        if cfg.frontend == "vision_stub":
            logits = logits[:, -labels.shape[1]:]
        logits, target = logits.float().flatten(0, -2), labels.flatten().long()
        if is_dtensor(logits):
            nll = vocab_nll(logits, target)
        else:   # -logp[label], as nll_loss takes it
            nll = F.nll_loss(torch.log_softmax(logits, dim=-1), target, reduction="none")
        return nll.view(labels.shape), aux


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

    dense, moe, vlm (and audio, which has no decode step): KV cache k, v
    (L, b, hkv, max_seq, dh), a vlm's counting its prefix positions.  ssm: ``state``
    (L, b, nh, hd, st) f32 and ``conv`` (L, b, 3, conv_dim) in the model
    dtype, whatever ``max_seq``.  hybrid: those two, and ``shared_k``, ``shared_v`` (G, b,
    hkv, max_seq, dh), one slot for each of the G = L // attn_every calls of
    the one shared block.  ``device="meta"`` gives shapes and dtypes only.
    """
    _check_family(cfg)
    dtype = dtype or torch_dtype(cfg)
    L, hkv, dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    if cfg.family in _ATTN_FAMILIES:
        shape = (L, batch_size, hkv, max_seq, dh)
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        }
    conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_state
    cache = {
        "state": torch.zeros((L, batch_size, cfg.ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((L, batch_size, ssm_mod.CONV_K - 1, conv_dim), dtype=dtype,
                            device=device),
    }
    if cfg.family == "hybrid" and cfg.attn_every:
        shape = (L // cfg.attn_every, batch_size, hkv, max_seq, dh)
        cache["shared_k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["shared_v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


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
    if cfg.family in _ATTN_FAMILIES:
        for i, lp in enumerate(params["layers"]):
            x, _, k, v = _layer(lp, cfg, x, plain=plain, layer=i)
            cache["k"][i, :, :, :s] = k
            cache["v"][i, :, :, :s] = v
    else:
        every = _shared_every(cfg)
        for i, lp in enumerate(params["layers"]):
            x, cache["state"][i], cache["conv"][i] = _ssm_layer(lp, cfg, x, plain=plain,
                                                                return_cache=True)
            if every and (i + 1) % every == 0:
                g = i // every
                x, _, k, v = _layer(params["shared_attn"], cfg, x, plain=plain)
                cache["shared_k"][g, :, :, :s] = k
                cache["shared_v"][g, :, :, :s] = v
    x = rmsnorm_apply(params["final_norm"], x, plain=plain)
    return x @ _head(params, cfg), cache


@torch.inference_mode()
def decode_step(params, cfg: ModelConfig, cache, token, pos: int, *, plain: bool = False):
    """One serve step: token (b, 1) int, pos the token's position (a vlm's
    counts its prefix).

    Returns (logits (b, vocab), cache); the cache is updated in place.  The
    ssm family's state carries the position, so ``pos`` is not read there.
    An encoder-only config (audio) has no decode step and raises.
    """
    _check_family(cfg)
    if not cfg.has_decode:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    x = _embed(params["embed"], token)
    kv = ("k", "v") if cfg.family in _ATTN_FAMILIES else ("shared_k", "shared_v")
    if kv[0] in cache and not 0 <= pos < cache[kv[0]].shape[3]:
        raise ValueError(f"pos {pos} outside the cache's {cache[kv[0]].shape[3]} positions")
    if cfg.family in _ATTN_FAMILIES:
        for i, lp in enumerate(params["layers"]):
            x = _attn_decode_block(lp, cfg, x, cache["k"][i], cache["v"][i], pos, plain=plain,
                                   layer=i)
    else:
        every = _shared_every(cfg)
        for i, lp in enumerate(params["layers"]):
            y, cache["state"][i], cache["conv"][i] = ssm_mod.ssm_decode_step(
                lp["ssm"], rmsnorm_apply(lp["norm1"], x, plain=plain), cache["state"][i],
                cache["conv"][i], cfg, plain=plain)
            x = x + y
            if every and (i + 1) % every == 0:
                g = i // every
                x = _attn_decode_block(params["shared_attn"], cfg, x, cache["shared_k"][g],
                                       cache["shared_v"][g], pos, plain=plain)
    x = rmsnorm_apply(params["final_norm"], x, plain=plain)
    return (x @ _head(params, cfg))[:, 0], cache


def _attn_decode_block(lp, cfg, x, cache_k, cache_v, pos, *, plain, layer=0):
    """One attention block at one token, writing its k, v at ``pos`` of
    ``cache_k`` / ``cache_v`` (b, hkv, max_seq, dh) in place."""
    x = x + attention_decode(lp["attn"], rmsnorm_apply(lp["norm1"], x, plain=plain),
                             cache_k, cache_v, pos, cfg, plain=plain)
    return x + _ffn(lp, cfg, rmsnorm_apply(lp["norm2"], x, plain=plain), layer=layer)[0]


@torch.inference_mode()
def generate(params, cfg: ModelConfig, batch, *, num_tokens: int,
             max_seq: int | None = None, plain: bool = False) -> torch.Tensor:
    """Greedy generation: prefill the prompt, then decode step by step.

    batch: {"tokens": (b, s)} prompt, and a vlm's "prefix_embeds" (b, P, d).
    Decoding starts at the embedded length, P + s for a vlm (the JAX
    package's ``generate`` counts the text alone there: ROADMAP C-7).
    Returns (b, num_tokens) int32.
    """
    if not cfg.has_decode:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    s = cfg.prefix_len + batch["tokens"].shape[1]
    max_seq = max_seq or (s + num_tokens)
    logits, cache = prefill(params, cfg, batch, max_seq, plain=plain)
    token = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
    out = [token]
    for i in range(num_tokens - 1):
        logits, cache = decode_step(params, cfg, cache, token, s + i, plain=plain)
        token = logits.argmax(dim=-1)[:, None].to(torch.int32)
        out.append(token)
    return torch.cat(out, dim=1)
