"""Training and serving steps, coded and uncoded.  Port of
``src/repro/train/coded.py``.

``make_coded_train_step`` is the paper's GC round as one step: the batch
arrives as the replicated chunk view (n, slots, chunk_bs, ...) with
per-(worker, slot) weights

    w[i, j] = beta_i * (1 - straggler_i) * alpha_{i, c(i,j)}

so the decoded gradient is the gradient of the weighted scalar loss

    L = sum_ij w[i, j] * loss_sum(chunk_ij) / (num_chunks * chunk_bs)

When the survivor decode vector beta solves the GC system,
``sum_i w[i, j(c)] == 1`` for every data chunk c and the gradient is
*exactly* the full-batch gradient: the weighted sum IS the GC decoder.
Stragglers enter as zeroed weights; their slots' compute is dead weight, as
a cancelled worker's is.  Any scheme maps its decode onto such a grid
(``scheme.chunk_grid`` / ``chunk_slots`` / ``decode_weights``), and
``num_chunks`` overrides the normaliser when the grid covers more than
``n`` chunks (M-SGC's subchunk expansion, uncoded's single column).

The JAX package ``vmap``s the chunk loss over the (n, slots) grid; here the
grid is one batch dimension of n * slots * chunk_bs sequences through one
forward, and each sequence's mean NLL is weighted by its slot's weight.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import decode_step, init_params, loss_fn, token_nll
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.tree import tree_flatten, tree_unflatten


def value_and_grad(fn, params):
    """(fn(params), d fn / d params) for a scalar fn of a parameter tree.

    The parameters are differentiated through detached aliases, so the
    caller's tensors are neither copied nor marked as requiring grad.
    """
    leaves, spec = tree_flatten(params)
    with torch.enable_grad():
        xs = [p.detach().requires_grad_(True) for p in leaves]
        value = fn(tree_unflatten(spec, xs))
        grads = torch.autograd.grad(value, xs)
    return value.detach(), tree_unflatten(spec, list(grads))


def make_train_step(cfg: ModelConfig, *, lr: float = 1e-4, weight_decay: float = 0.0):
    """Plain (uncoded) train step: (params, opt, batch) -> (params, opt, metrics)."""

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(lambda p: loss_fn(p, cfg, batch), params)
        params, opt_state = adamw_update(params, grads, opt_state, lr=lr,
                                         weight_decay=weight_decay)
        return params, opt_state, {"loss": loss}

    return step


def chunk_loss_sum(params, cfg: ModelConfig, chunk_batch):
    """SUM-reduced loss over one chunk (partial gradients must add up to the
    full-batch gradient, so per-chunk reduction is a sum over examples)."""
    n_ex = chunk_batch["tokens"].shape[0]
    return loss_fn(params, cfg, chunk_batch, aux_weight=0.0) * n_ex


def coded_loss(params, cfg: ModelConfig, coded_batch, weights, num_chunks: int, *,
               plain: bool = False):
    """Weighted coded loss of the (n, slots, chunk_bs, ...) view (module
    docstring): every sequence's mean token NLL, times its slot's weight,
    summed and divided by ``num_chunks * chunk_bs`` — the sum over slots of
    ``w[i, j] * chunk_loss_sum(chunk_ij)`` over the same normaliser."""
    n, slots, cb = coded_batch["tokens"].shape[:3]
    flat = {k: v.reshape(n * slots * cb, *v.shape[3:]) for k, v in coded_batch.items()}
    nll, _ = token_nll(params, cfg, flat, plain=plain)          # aux_weight = 0
    w = weights.to(nll.device, torch.float32).reshape(-1).repeat_interleave(cb)
    return (w * nll.mean(dim=1)).sum() / (num_chunks * cb)


def make_coded_train_step(cfg: ModelConfig, n: int, s: int, *, lr: float = 1e-4,
                          weight_decay: float = 0.0, num_chunks: int | None = None):
    """GC-coded train step: (params, opt, coded_batch, weights) -> (params,
    opt, metrics).

    coded_batch — tensors (n, slots, chunk_bs, ...): the cyclic view of
      ``data.gc_chunked_batch`` or the scheme-generic one of
      ``data.coded_slot_batch`` (the step never reads ``s``);
    weights     — (n, slots) f32 folding alpha, beta and the straggler mask
      (``gc_round_weights``, or ``scheme.decode_weights`` in general).

    ``num_chunks`` (default ``n``) is how many equal chunks the job's batch
    was split into: ``num_chunks * chunk_bs`` must be the job's batch size.
    """
    total_chunks = n if num_chunks is None else num_chunks

    def step(params, opt_state, coded_batch, weights):
        loss, grads = value_and_grad(
            lambda p: coded_loss(p, cfg, coded_batch, weights, total_chunks),
            params,
        )
        params, opt_state = adamw_update(params, grads, opt_state, lr=lr,
                                         weight_decay=weight_decay)
        return params, opt_state, {"loss": loss}

    return step


def gc_round_weights(code, survivors) -> torch.Tensor:
    """(n, s+1) f32 weights for one steady-state GC round.

    code: GradientCode/RepGradientCode; survivors: worker ids that returned
    results.  w[i, j] = beta_i * alpha_{i, chunk(i, j)}.
    """
    n = code.n
    beta = code.decode_vector(sorted(survivors))
    w = np.zeros((n, code.s + 1), dtype=np.float32)
    for i in range(n):
        chunks = code.chunks_of_worker(i)
        w[i] = beta[i] * code.encode_matrix[i, chunks]
    return torch.from_numpy(w)


def make_serve_step(cfg: ModelConfig):
    def step(params, cache, token, pos: int):
        return decode_step(params, cfg, cache, token, pos)

    return step


def init_train_state(cfg: ModelConfig, gen: torch.Generator):
    """Random parameters from ``gen`` (on ``gen.device``) and fresh AdamW state."""
    params = init_params(cfg, gen)
    return params, adamw_init(params)
