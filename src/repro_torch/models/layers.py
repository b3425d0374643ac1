"""Transformer layers: RMSNorm, RoPE, GQA attention (prefill and cached
decode), the SwiGLU MLP and the top-K mixture of experts.

Port of ``src/repro/models/layers.py``.  Parameters are plain dicts of
tensors in the JAX package's layout: a dense weight is (d_in, d_out) and is
applied as ``x @ w``.  RMSNorm, RoPE and training / prefill attention go
through the kernel ops, which pick the kernels (forward and backward) or the
plain version by the tensor's device; ``plain=True`` takes the plain version
on any device, through ordinary autograd, which is how a run on the card is
held against the same arithmetic without the kernels.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from repro_torch.dtensor import grad_in_layout, is_dtensor, local_shards, split_dim
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.kernels.rmsnorm import ref as rn_ref
from repro_torch.kernels.rope import ops as rope_ops
from repro_torch.kernels.rope import ref as rope_ref
from repro_torch.tracing import span

NEG_INF = -1e30


# -- init helpers -------------------------------------------------------------


def init_device(gen: torch.Generator | None) -> torch.device:
    """Where the init draws: ``gen``'s device, or with no generator the meta
    device (shapes and dtypes only, no storage)."""
    return torch.device("meta") if gen is None else gen.device


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype: torch.dtype,
               scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, device=init_device(gen)) * scale
    return w.to(dtype)


# -- RMSNorm ------------------------------------------------------------------


def rmsnorm_init(d: int, dtype: torch.dtype, device) -> dict:
    return {"gamma": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(p, x, *, plain: bool = False, eps: float = 1e-6):
    if plain:
        return rn_ref.rmsnorm(x, p["gamma"], eps=eps)
    return rn_ops.rmsnorm(x, p["gamma"], eps=eps)


# -- RoPE ---------------------------------------------------------------------


def rope_apply(q, k, positions, theta: float, *, plain: bool = False):
    """q (b, hq, s, dh) and k (b, hkv, s, dh) rotated by ``positions`` ((s,)
    or (b, s)): split-half, in f32.  The kernel op on the card, one launch for
    both; ``plain=True`` takes the plain version on any device."""
    if plain:
        return (rope_ref.apply_rope(q, positions, theta),
                rope_ref.apply_rope(k, positions, theta))
    return rope_ops.rope(q, k, positions, theta)


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
            p[name] = torch.zeros((width,), dtype=dtype, device=init_device(gen))
    return p


def _project_qkv(p, x, cfg, positions, *, plain: bool = False):
    """Returns q (b, hq, s, dh) and k (b, hkv, s, dh), rotated, and v (b, hkv,
    s, dh) as a head-transposed view."""
    b, s, _ = x.shape
    dh = cfg.head_dim_
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = split_dim(q, -1, cfg.num_heads).reshape(b, s, cfg.num_heads, dh).transpose(1, 2)
    k = split_dim(k, -1, cfg.num_kv_heads).reshape(b, s, cfg.num_kv_heads, dh).transpose(1, 2)
    v = split_dim(v, -1, cfg.num_kv_heads).reshape(b, s, cfg.num_kv_heads, dh).transpose(1, 2)
    q, k = rope_apply(q, k, positions, cfg.rope_theta, plain=plain)
    return q, k, v


def attention_apply(p, x, cfg, *, positions=None, plain: bool = False):
    """Training / prefill path. x: (b, s, d).  Returns (out, (k, v))."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions, plain=plain)
    out = multihead_attention(
        q, k, v, causal=cfg.causal, window=cfg.sliding_window, plain=plain
    )
    out = grad_in_layout(out.transpose(1, 2).reshape(b, s, -1))
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


def attention_decode(p, x, cache_k, cache_v, pos: int, cfg, *, plain: bool = False):
    """Single-token decode against a KV cache, which it updates in place.

    x: (b, 1, d); cache_k/v: (b, hkv, S, dh); pos: current position (tokens
    < pos are valid).  Returns out (b, 1, d).  The products are plain
    ``torch.matmul`` as in the JAX package, which leaves them to XLA; RoPE
    takes the kernel op, or with ``plain=True`` the plain version.
    """
    b = x.shape[0]
    dh = cfg.head_dim_
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions, plain=plain)
    cache_k[:, :, pos] = k_new[:, :, 0]
    cache_v[:, :, pos] = v_new[:, :, 0]
    # GQA without materialising the repeat: fold the q heads into
    # (kv_head, group) and contract against the cache directly, in the
    # cache's dtype with f32 accumulation and f32 scores, as the JAX package
    # does (casting the whole cache to f32 would double its read traffic).
    group = cfg.num_heads // cfg.num_kv_heads
    qg = split_dim(q, 1, cfg.num_kv_heads).reshape(b, cfg.num_kv_heads, group, dh)
    qg = qg.to(cache_k.dtype)
    core = lambda qg, ck, cv: _decode_core(qg, ck, cv, pos, cfg)  # noqa: E731
    # on DTensors each rank takes its batch rows and kv heads, the cache's
    # sequence gathered where it is sharded (``local_shards``)
    out = (local_shards(core, [qg, cache_k, cache_v], (0, 1)) if is_dtensor(qg)
           else core(qg, cache_k, cache_v))
    out = out.to(x.dtype).reshape(b, 1, cfg.num_heads * dh)
    return out @ p["wo"]


def _decode_core(qg, cache_k, cache_v, pos: int, cfg):
    """The decode step's attention: qg (b, hkv, g, dh) against the cache's
    positions up to ``pos`` (and within the window); (b, hkv, g, dh) in the
    cache's dtype."""
    s = _f32_product(qg, cache_k.transpose(-1, -2)) * (cfg.head_dim_ ** -0.5)  # (b, hkv, g, S)
    k_pos = torch.arange(cache_k.shape[2], device=qg.device)
    valid = k_pos <= pos
    if cfg.sliding_window > 0:
        valid &= (pos - k_pos) < cfg.sliding_window
    s = s.masked_fill(~valid, NEG_INF)
    pvals = torch.softmax(s, dim=-1)
    return pvals.to(cache_v.dtype) @ cache_v


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
        w = torch.randn((E, d_in, d_out), generator=gen, device=init_device(gen)) * d_in ** -0.5
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
    """The routing of successive ``moe_apply`` calls, keyed by layer: for each
    call its experts ``idx`` (T, K), its ``kept`` mask (T, K) (None where the
    group runs dropless) and ``gap``, each token's K-th minus (K+1)-th
    probability (1 where K = E).

    ``calls`` holds them in call order, one for each layer a pass (a forward,
    a prefill, a decode step), and ``layers`` each call's layer.  A layer body
    that runs again in the backward (``_remat``'s recompute, see
    :func:`recompute_routes`) takes its forward's record and records nothing,
    so a training step records each layer once.  The recompute reads the
    record by its place in ``calls``, fixed when its forward ran, so a second
    forward under the same log before the first's backward (gradient
    accumulation) does not change what the first's recompute replays.

    Checks only: under :func:`route_log` a run records its routing, and a
    log made with ``replay`` set to another log takes, for its n-th call of a
    layer, that log's experts of the n-th call of the same layer in place of
    its own choice (the kept mask follows from the experts).  That holds two
    paths' arithmetic against each other where rounding would tip a near tie
    at the K-th place to another expert."""

    def __init__(self, replay: "RouteLog | None" = None):
        self.calls: list[tuple] = []
        self.layers: list[int] = []
        self.replay = replay

    def call(self, layer: int, n: int = -1) -> tuple:
        """The n-th recorded call of ``layer`` (the last by default)."""
        return self.calls[[i for i, got in enumerate(self.layers) if got == layer][n]]

    def experts(self, layer: int, top: torch.Tensor) -> torch.Tensor:
        """The call's experts: ``top``, this run's own choice, or the
        replayed log's choice for the same layer and pass."""
        if self.replay is None:
            return top
        return self.replay.call(layer, self.layers.count(layer))[0]

    def record(self, layer: int, idx, kept, gap) -> None:
        self.calls.append((idx, kept, gap))
        self.layers.append(layer)

    def drops(self) -> list[int]:
        """Dropped (token, expert) pairs of each call."""
        return [0 if kept is None else int((~kept).sum()) for _, kept, _ in self.calls]

    def to(self, device) -> "RouteLog":
        """A copy of the record (not of ``replay``) with its tensors on ``device``."""
        log = RouteLog()
        log.calls = [tuple(None if t is None else t.to(device) for t in c) for c in self.calls]
        log.layers = list(self.layers)
        return log


_ROUTE_LOG: contextvars.ContextVar = contextvars.ContextVar("route_log", default=None)
# while a layer body runs again in the backward (``recompute_routes``): the
# place in the log's ``calls`` of the record its forward made
_RECOMPUTE: contextvars.ContextVar = contextvars.ContextVar("route_recompute", default=None)


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


def recompute_routes():
    """The context for the backward's recompute of a layer body under
    activation checkpointing (``models/transformer.py`` ``_remat``), made at
    the forward: the recompute runs under the forward's route log, read now
    (the backward may run in another thread, which sees no log), and its
    ``moe_apply`` takes the record that the forward is about to make, the
    log's next, and records nothing.  A null context where no log is active."""
    log = _ROUTE_LOG.get()
    if log is None:
        return contextlib.nullcontext()
    return _recomputing(log, len(log.calls))


@contextlib.contextmanager
def _recomputing(log: RouteLog, index: int):
    token, again = _ROUTE_LOG.set(log), _RECOMPUTE.set(index)
    try:
        yield
    finally:
        _RECOMPUTE.reset(again)
        _ROUTE_LOG.reset(token)


def moe_apply(p, x, cfg, *, capacity_factor: float = 1.25, group_size: int = 1024,
              segment: int | None = None, layer: int = 0):
    """Top-K token-choice MoE with grouped capacity.

    x: (b, s, d) -> ((b, s, d), aux load-balance loss).  The JAX package's
    function: the router product in the model dtype, softmax in f32, the K
    most probable experts (ties to the lower index, as ``jax.lax.top_k``),
    their probabilities renormalised over the K; in each group of Tg tokens
    (:func:`moe_groups`) a token keeps expert e iff fewer than Cg earlier
    tokens of its group chose e; a dropped pair adds nothing and its weight is
    not renormalised away; the shared experts take every token; aux =
    E * sum_e mean(probs)_e * mean(chosen)_e / K over the whole batch, chosen
    counted before drops.

    ``segment`` is the token count of one independent segment of the batch,
    consecutive in its flat (b * s) order: a coded chunk, which the JAX
    package's coded loss runs through the model on its own (``vmap``).  The
    groups are taken from one segment, ``moe_groups(segment)``, so none
    crosses a segment and the result is the JAX package's over each segment
    alone; the default is the whole batch.  ``layer`` keys the call in a
    :class:`RouteLog`.

    The JAX package forms (G, Tg, E, Cg) one-hot dispatch and combine
    tensors and runs the experts over every one of E * Cg slots; here only the
    kept pairs run.  They are sorted by expert (stable, so in token order
    within an expert), each expert's rows are gathered and go through three
    products, and each token gathers its K outputs (a zero row for a dropped
    pair) and combines them in one (1, K) @ (K, d) product with the gate
    values cast to the model dtype: one f32 accumulation, rounded once, and no
    atomics, so the forward is deterministic on the card.

    On the meta device (the dry-run) no routing exists, and each expert takes
    G x Cg rows, the capacity form's.

    Cost of a layer on the card: one host sync (the experts' row counts go to
    the host to slice the sorted rows), some 70 device launches for the
    router, sorts, gathers, combine, aux and shared experts, and 5 for each
    expert that received a row (gate, up and down products, silu, product):
    at qwen2-moe-a2.7b's 8 x 500 prefill all 60 experts, in a decode step of
    8 tokens about 21.  The layer runs in the span ``moe``
    (``repro_torch.tracing.span``), which chip_smoke.py's profiles read.
    """
    with span("moe"):
        b, s, d = x.shape
        E, K = cfg.num_experts, cfg.num_experts_per_tok
        T = b * s
        segment = T if segment is None else segment
        if segment <= 0 or T % segment:
            raise ValueError(f"segments of {segment} tokens do not split the batch's {T}")
        Tg, Cg = moe_groups(segment, cfg, capacity_factor, group_size)
        xt = x.reshape(T, d)
        if is_dtensor(xt):
            out, me, ce = _moe_sharded(p, xt, cfg, Tg, Cg, segment, layer)
        else:
            gate, idx, kept, me, ce = _moe_route(p["router"], xt, cfg, Tg, Cg, layer)
            out = _moe_experts(p, xt, gate, idx, kept, cfg, Tg, Cg)
        aux = E * (me * ce).sum() / K
        return out.reshape(b, s, d), aux


def _moe_route(router, xt, cfg, Tg: int, Cg: int, layer: int):
    """The routing of ``moe_apply`` over the (T, d) tokens ``xt``: (gate (T, K),
    idx (T, K), kept (T, K) or None where dropless, the mean probability and
    the mean choice of each expert)."""
    T = xt.shape[0]
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    probs = torch.softmax((xt @ router).float(), dim=-1)                    # (T, E)
    log, again = _ROUTE_LOG.get(), _RECOMPUTE.get()
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    if log is None:
        idx = order[:, :K]
    elif again is not None:
        if log.layers[again] != layer:
            raise RuntimeError(f"the recompute of layer {layer} found the record of layer "
                               f"{log.layers[again]} where its forward's should be")
        idx = log.calls[again][0]
    else:
        idx = log.experts(layer, order[:, :K])
    gate = probs.gather(1, idx)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)

    # a token picks each expert at most once: its choices as a (T, E) one-hot
    chosen = torch.zeros_like(probs).scatter_(1, idx, 1.0)
    kept = None
    if Cg < Tg:
        pos = chosen.view(T // Tg, Tg, E).cumsum(1).view(T, E).gather(1, idx) - 1.0
        kept = pos < Cg
    if log is not None and again is None:
        gap = ranked[:, K - 1] - ranked[:, K] if K < E else torch.full_like(probs[:, 0], 1.0)
        log.record(layer, idx, kept, gap.detach())
    return gate, idx, kept, probs.mean(0), chosen.mean(0)


def _moe_experts(p, xt, gate, idx, kept, cfg, Tg: int, Cg: int):
    """The experts' part of ``moe_apply``: each kept (token, expert) pair
    through its expert, combined by ``gate``, and the shared experts over
    every token.  Returns (T, d)."""
    T, d = xt.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    # the kept pairs by expert; a dropped pair sorts last, as expert E
    pair_e = idx.reshape(-1) if kept is None else idx.masked_fill(~kept, E).reshape(-1)
    by_e = torch.argsort(pair_e, stable=True)
    if xt.device.type == "meta":
        # shapes only, so no routing: each expert takes the G x Cg rows of
        # the JAX package's capacity form, the most a step can route to it,
        # and its products are that package's dispatch work
        counts = [T // Tg * Cg] * E + [0]
        take = by_e.new_zeros(sum(counts))
    else:
        counts = torch.zeros(E + 1, dtype=torch.long, device=xt.device)
        counts = counts.index_add_(0, pair_e, torch.ones_like(pair_e)).tolist()  # host sync
        take = by_e[:T * K - counts[E]]
    n = len(take)
    # each kept pair's row of x, gathered from the (T * K, d) copy of xt
    # repeated over K, whose rows are the pairs: no index repeats, so the
    # gather's backward writes each row once and expand's backward sums a
    # token's K rows in a fixed order (deterministic on the card, where an
    # accumulating scatter over repeated indices need not be)
    rows = xt[:, None].expand(T, K, d).reshape(T * K, d)[take]
    # each expert's rows as one split, whose backward is one concatenation
    # (a slice's backward would write a zero-padded (n, d) gradient an
    # expert and add them up)
    outs = []
    for wg, wu, wd, xe in zip(p["w_gate"].unbind(0), p["w_up"].unbind(0),
                              p["w_down"].unbind(0), rows.split(counts[:E])):
        if len(xe):
            outs.append((F.silu(xe @ wg) * (xe @ wu)) @ wd)
    outs.append(xt.new_zeros((1, d)))                  # what a dropped pair reads
    y = torch.cat(outs)                                # (n + 1, d)
    # each pair's row in y: its place in the sorted order, or the zero row.
    # Only the zero row repeats (once for each dropped pair), and its
    # gradient is thrown away: it is a constant, not an expert's output.
    slot = torch.empty_like(by_e)
    slot[by_e] = torch.arange(T * K, device=xt.device)
    routed = torch.bmm(gate.to(xt.dtype)[:, None, :], y[slot.clamp_(max=n)].view(T, K, d))
    out = routed.view(T, d)
    if cfg.num_shared_experts:
        out = out + mlp_apply(p["shared"], xt)
    return out


def _moe_sharded(p, xt, cfg, Tg: int, Cg: int, segment: int, layer: int):
    """``moe_apply`` on DTensor tokens ``xt`` (T, d): (out, mean probability,
    mean choice), DTensors.  The routing and the experts run on each rank's
    own tokens, the way a rank would run them, and DTensor sees only their
    boundaries; its op-by-op rules would gather the whole batch at the sort.

    Each mesh axis takes one role.  "batch": the tokens are sharded on it and
    each shard holds whole capacity groups (whole segments of a coded chunk),
    so a rank's routing is the batch's; the expert weights are gathered on it
    (FSDP).  "tp": the expert weights (and the shared experts') are sharded
    on their hidden dimension f on it; the routing is repeated on each of its
    ranks, each runs its slice of every expert, and the output is a pending
    sum.  Any other axis holds everything whole."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = xt.device_mesh
    T = xt.shape[0]
    unit = segment if segment < T else Tg
    sharded = [(p["w_gate"], 2), (p["w_up"], 2), (p["w_down"], 1)]
    if cfg.num_shared_experts:
        sharded += [(p["shared"]["w_gate"], 1), (p["shared"]["w_up"], 1),
                    (p["shared"]["w_down"], 0)]
    roles, parts = [], 1
    for i, placed in enumerate(xt.placements):
        n = mesh.size(i)
        if placed == Shard(0) and T % (parts * n) == 0 and T // (parts * n) % unit == 0:
            roles.append("batch")
            parts *= n
        elif all(w.placements[i] == Shard(f) for w, f in sharded):
            roles.append("tp")
        else:
            roles.append(None)

    def lay(batch=Replicate(), tp=Replicate()):
        return tuple({"batch": batch, "tp": tp, None: Replicate()}[r] for r in roles)

    x = xt.redistribute(mesh, lay(batch=Shard(0)))
    router = p["router"].redistribute(mesh, lay()).to_local(grad_placements=lay(batch=Partial()))
    gate, idx, kept, me, ce = _moe_route(router, x.to_local(), cfg, Tg, Cg, layer)
    # the expert part's gradients: a tp rank's slice of f gives a part of the
    # tokens' and gates' gradients, a batch rank its tokens' part of the weights'
    partial = lay(batch=Shard(0), tp=Partial())
    gate = DTensor.from_local(gate, mesh, lay(batch=Shard(0))).to_local(grad_placements=partial)

    def local(w, f):
        return w.redistribute(mesh, lay(tp=Shard(f))).to_local(
            grad_placements=lay(batch=Partial(), tp=Shard(f)))

    experts = {"w_gate": local(p["w_gate"], 2), "w_up": local(p["w_up"], 2),
               "w_down": local(p["w_down"], 1)}
    if cfg.num_shared_experts:
        experts["shared"] = {k: local(p["shared"][k], f)
                             for k, f in (("w_gate", 1), ("w_up", 1), ("w_down", 0))}
    out = _moe_experts(experts, x.to_local(grad_placements=partial), gate, idx, kept, cfg,
                       Tg, Cg)
    out = DTensor.from_local(out, mesh, lay(batch=Shard(0), tp=Partial()))
    # the batch's means are the sum over the batch ranks of their own means / ranks
    # (made whole: a pending sum beside the loss's pending mean cannot be
    # added to it in some torch versions)
    means = [DTensor.from_local(v / parts, mesh, lay(batch=Partial())).redistribute(mesh, lay())
             for v in (me, ce)]
    return out, *means
