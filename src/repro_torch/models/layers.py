"""Transformer layers: RMSNorm, RoPE, GQA attention (prefill and cached
decode), the SwiGLU MLP and the top-K mixture of experts.

Port of ``src/repro/models/layers.py``.  Parameters are plain dicts of
tensors in the JAX package's layout: a dense weight is (d_in, d_out) and is
applied as ``x @ w``.  RMSNorm and training / prefill attention go through
the kernel ops, which pick the kernels (forward and backward) or the plain
version by the tensor's device; ``plain=True`` takes the plain version on any
device, through ordinary autograd, which is how a run on the card is held
against the same arithmetic without the kernels.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.kernels.rmsnorm import ref as rn_ref

NEG_INF = -1e30


def _span(name: str):
    """A profiler range named ``name`` (chip_smoke.py's profiles read them:
    the passes of the chunked scan, ``ssd.*``, and each ``moe`` layer); a null
    context, which records nothing, when no profiler runs."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


# -- init helpers -------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype: torch.dtype,
               scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device) * scale
    return w.to(dtype)


# -- RMSNorm ------------------------------------------------------------------


def rmsnorm_init(d: int, dtype: torch.dtype, device) -> dict:
    return {"gamma": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(p, x, *, plain: bool = False, eps: float = 1e-6):
    if plain:
        return rn_ref.rmsnorm(x, p["gamma"], eps=eps)
    return rn_ops.rmsnorm(x, p["gamma"], eps=eps)


# -- RoPE ---------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (b, h, s, dh); positions: (b, s) or (s,).  Split-half rotation in f32."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)               # (dh/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs               # (b, s, dh/2)
    cos = torch.cos(angles)[:, None, :, :]
    sin = torch.sin(angles)[:, None, :, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -- attention ----------------------------------------------------------------


def multihead_attention(q, k, v, *, causal: bool, window: int = 0, plain: bool = False):
    if plain:
        return fa_ref.attention(q, k, v, causal=causal, window=window)
    return fa_ops.attention(q, k, v, causal=causal, window=window)


def attention_init(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    d, dh = cfg.d_model, cfg.head_dim_
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": dense_init(gen, d, hq * dh, dtype),
        "wk": dense_init(gen, d, hkv * dh, dtype),
        "wv": dense_init(gen, d, hkv * dh, dtype),
        "wo": dense_init(gen, hq * dh, d, dtype),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", hq * dh), ("bk", hkv * dh), ("bv", hkv * dh)):
            p[name] = torch.zeros((width,), dtype=dtype, device=gen.device)
    return p


def _project_qkv(p, x, cfg, positions):
    """Returns q (b, hq, s, dh) and k, v (b, hkv, s, dh) as head-transposed views."""
    b, s, _ = x.shape
    dh = cfg.head_dim_
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.num_heads, dh).transpose(1, 2)
    k = k.reshape(b, s, cfg.num_kv_heads, dh).transpose(1, 2)
    v = v.reshape(b, s, cfg.num_kv_heads, dh).transpose(1, 2)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_apply(p, x, cfg, *, positions=None, plain: bool = False):
    """Training / prefill path. x: (b, s, d).  Returns (out, (k, v))."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = multihead_attention(
        q, k, v, causal=cfg.causal, window=cfg.sliding_window, plain=plain
    )
    out = out.transpose(1, 2).reshape(b, s, -1)
    return out @ p["wo"], (k, v)


def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over leading batch dims, accumulated in f32 with an f32 result.

    On the card, cuBLAS takes bf16 operands in place (``out_dtype``).  The
    CPU has no such product, so there the operands are upcast first.
    """
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.device.type != "cuda":
        return a.float() @ b.float()
    lead = a.shape[:-2]
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                    out_dtype=torch.float32)
    return out.reshape(*lead, a.shape[-2], b.shape[-1])


def attention_decode(p, x, cache_k, cache_v, pos: int, cfg):
    """Single-token decode against a KV cache, which it updates in place.

    x: (b, 1, d); cache_k/v: (b, hkv, S, dh); pos: current position (tokens
    < pos are valid).  Returns out (b, 1, d).  The products are plain
    ``torch.matmul`` as in the JAX package, which leaves them to XLA.
    """
    b = x.shape[0]
    dh = cfg.head_dim_
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    cache_k[:, :, pos] = k_new[:, :, 0]
    cache_v[:, :, pos] = v_new[:, :, 0]
    # GQA without materialising the repeat: fold the q heads into
    # (kv_head, group) and contract against the cache directly, in the
    # cache's dtype with f32 accumulation and f32 scores, as the JAX package
    # does (casting the whole cache to f32 would double its read traffic).
    group = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(b, cfg.num_kv_heads, group, dh).to(cache_k.dtype)
    s = _f32_product(qg, cache_k.transpose(-1, -2)) * (dh ** -0.5)  # (b, hkv, g, S)
    k_pos = torch.arange(cache_k.shape[2], device=x.device)
    valid = k_pos <= pos
    if cfg.sliding_window > 0:
        valid &= (pos - k_pos) < cfg.sliding_window
    s = s.masked_fill(~valid, NEG_INF)
    pvals = torch.softmax(s, dim=-1)
    out = (pvals.to(cache_v.dtype) @ cache_v).to(x.dtype)           # (b, hkv, g, dh)
    out = out.reshape(b, 1, cfg.num_heads * dh)
    return out @ p["wo"]


# -- SwiGLU MLP ---------------------------------------------------------------


def mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype: torch.dtype) -> dict:
    return {
        "w_gate": dense_init(gen, d, d_ff, dtype),
        "w_up": dense_init(gen, d, d_ff, dtype),
        "w_down": dense_init(gen, d_ff, d, dtype),
    }


def mlp_apply(p, x):
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


# -- Mixture of Experts --------------------------------------------------------


def moe_init(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    d, e_ff, E = cfg.d_model, cfg.expert_d_ff, cfg.num_experts

    def experts(d_in, d_out):
        w = torch.randn((E, d_in, d_out), generator=gen, device=gen.device) * d_in ** -0.5
        return w.to(dtype)

    p = {
        "router": dense_init(gen, d, E, dtype),
        "w_gate": experts(d, e_ff),
        "w_up": experts(d, e_ff),
        "w_down": experts(e_ff, d),
    }
    if cfg.num_shared_experts:
        p["shared"] = mlp_init(gen, d, cfg.num_shared_experts * e_ff, dtype)
    return p


def moe_groups(T: int, cfg, capacity_factor: float = 1.25,
               group_size: int = 1024) -> tuple[int, int]:
    """(Tg, Cg): the tokens of a group and each expert's capacity in it.

    Tg is ``min(group_size, T)`` halved until it divides T.  Groups of at most
    256 tokens (decode steps, smoke configs) run dropless, Cg = Tg; larger ones
    keep ``int(capacity_factor * Tg * K / E)`` pairs an expert.
    """
    Tg = min(group_size, T)
    while T % Tg:
        Tg //= 2
    if Tg <= 256:
        return Tg, Tg
    return Tg, max(int(capacity_factor * Tg * cfg.num_experts_per_tok / cfg.num_experts), 1)


class RouteLog:
    """The routing of successive ``moe_apply`` calls: for each call its
    experts ``idx`` (T, K), its ``kept`` mask (T, K) (None where the group
    runs dropless) and ``gap``, each token's K-th minus (K+1)-th probability
    (1 where K = E).

    Checks only: under :func:`route_log` a run records its routing, and a
    log made with ``replay`` set to another log takes that log's experts for
    its i-th call in place of its own choice (the kept mask follows from the
    experts).  That holds two paths' arithmetic against each other where
    rounding would tip a near tie at the K-th place to another expert."""

    def __init__(self, replay: "RouteLog | None" = None):
        self.calls: list[tuple] = []
        self.replay = replay

    def experts(self, top: torch.Tensor) -> torch.Tensor:
        """The call's experts: ``top``, this run's own choice, or the
        replayed log's choice for the same call."""
        return top if self.replay is None else self.replay.calls[len(self.calls)][0]

    def drops(self) -> list[int]:
        """Dropped (token, expert) pairs of each call."""
        return [0 if kept is None else int((~kept).sum()) for _, kept, _ in self.calls]


_ROUTE_LOG: contextvars.ContextVar = contextvars.ContextVar("route_log", default=None)


@contextlib.contextmanager
def route_log(log: RouteLog | None = None):
    """Record the routing of every ``moe_apply`` call in the block into
    ``log`` (a new :class:`RouteLog` by default; one with ``replay`` also pins
    it); yields the log."""
    log = RouteLog() if log is None else log
    token = _ROUTE_LOG.set(log)
    try:
        yield log
    finally:
        _ROUTE_LOG.reset(token)


def moe_apply(p, x, cfg, *, capacity_factor: float = 1.25, group_size: int = 1024):
    """Top-K token-choice MoE with grouped capacity.

    x: (b, s, d) -> ((b, s, d), aux load-balance loss).  The JAX package's
    function: the router product in the model dtype, softmax in f32, the K
    most probable experts (ties to the lower index, as ``jax.lax.top_k``),
    their probabilities renormalised over the K; in each group of Tg tokens
    (:func:`moe_groups`) a token keeps expert e iff fewer than Cg earlier
    tokens of its group chose e; a dropped pair adds nothing and its weight is
    not renormalised away; the shared experts take every token; aux =
    E * sum_e mean(probs)_e * mean(chosen)_e / K, chosen counted before drops.

    The JAX package forms (G, Tg, E, Cg) one-hot dispatch and combine
    tensors and runs the experts over every one of E * Cg slots; here only the
    kept pairs run.  They are sorted by expert (stable, so in token order
    within an expert), each expert's rows are gathered and go through three
    products, and each token gathers its K outputs (a zero row for a dropped
    pair) and combines them in one (1, K) @ (K, d) product with the gate
    values cast to the model dtype: one f32 accumulation, rounded once, and no
    atomics, so the forward is deterministic on the card.

    Cost of a layer on the card: one host sync (the experts' row counts go to
    the host to slice the sorted rows), some 70 device launches for the
    router, sorts, gathers, combine, aux and shared experts, and 5 for each
    expert that received a row (gate, up and down products, silu, product):
    at qwen2-moe-a2.7b's 8 x 500 prefill all 60 experts, in a decode step of
    8 tokens about 21.  The layer runs in a profiler range named ``moe``
    (``_span``), which chip_smoke.py's profiles read.
    """
    with _span("moe"):
        b, s, d = x.shape
        E, K = cfg.num_experts, cfg.num_experts_per_tok
        T = b * s
        Tg, Cg = moe_groups(T, cfg, capacity_factor, group_size)
        xt = x.reshape(T, d)
        probs = torch.softmax((xt @ p["router"]).float(), dim=-1)               # (T, E)
        log = _ROUTE_LOG.get()
        ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
        idx = order[:, :K] if log is None else log.experts(order[:, :K])
        gate = probs.gather(1, idx)
        gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)

        # a token picks each expert at most once: its choices as a (T, E) one-hot
        chosen = torch.zeros_like(probs).scatter_(1, idx, 1.0)
        kept = None
        if Cg < Tg:
            pos = chosen.view(T // Tg, Tg, E).cumsum(1).view(T, E).gather(1, idx) - 1.0
            kept = pos < Cg
        if log is not None:
            gap = ranked[:, K - 1] - ranked[:, K] if K < E else torch.full_like(probs[:, 0], 1.0)
            log.calls.append((idx, kept, gap.detach()))

        # the kept pairs by expert; a dropped pair sorts last, as expert E
        pair_e = idx.reshape(-1) if kept is None else idx.masked_fill(~kept, E).reshape(-1)
        by_e = torch.argsort(pair_e, stable=True)
        counts = torch.zeros(E + 1, dtype=torch.long, device=x.device)
        counts = counts.index_add_(0, pair_e, torch.ones_like(pair_e)).tolist()  # host sync
        n = T * K - counts[E]
        rows = xt[by_e[:n] // K]
        outs, start = [], 0
        for wg, wu, wd, c in zip(p["w_gate"].unbind(0), p["w_up"].unbind(0),
                                 p["w_down"].unbind(0), counts):
            if c:
                xe = rows[start:start + c]
                outs.append((F.silu(xe @ wg) * (xe @ wu)) @ wd)
                start += c
        outs.append(xt.new_zeros((1, d)))                  # what a dropped pair reads
        y = torch.cat(outs)                                # (n + 1, d)
        # each pair's row in y: its place in the sorted order, or the zero row
        slot = torch.empty_like(by_e)
        slot[by_e] = torch.arange(T * K, device=x.device)
        routed = torch.bmm(gate.to(x.dtype)[:, None, :], y[slot.clamp_(max=n)].view(T, K, d))
        out = routed.view(T, d)
        if cfg.num_shared_experts:
            out = out + mlp_apply(p["shared"], xt)

        me = probs.mean(0)
        ce = chosen.mean(0)
        aux = E * (me * ce).sum() / K
        return out.reshape(b, s, d), aux
