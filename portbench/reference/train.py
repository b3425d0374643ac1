"""The reference's first jobs of a cell: each job's full-batch loss and
gradient in f32, and AdamW on them, for each interleaved model.

A correct decode gives the job's full-batch gradient, whatever the scheme
and whoever straggled, so the reference computes that gradient directly:
the mean over the job's sequences of each sequence's mean NLL.  AdamW is
the configuration's (f32 moments, bias corrections in f32), and a parameter
kept in bf16 is rounded to bf16 after each update, as the configuration
keeps it.  The sequences run in blocks of ``rows``, each layer
checkpointed, so that a full-size model fits beside its f32 state.

``fp8_matmul`` is the control's product: the reference one precision below
the configuration's bf16, every product's operands (the projections, the
attention's and the SSD scan's products) quantised to float8 e4m3 with one
scale a tensor, gradients to e5m2, accumulated in f32.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .model import sequence_nll

FP8 = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _quantised(x: torch.Tensor, dtype) -> torch.Tensor:
    scale = FP8[dtype] / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).float() / scale


class _Fp8Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        aq, bq = _quantised(a, torch.float8_e4m3fn), _quantised(b, torch.float8_e4m3fn)
        ctx.save_for_backward(aq, bq)
        return aq @ bq

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = _quantised(g, torch.float8_e5m2)
        return (_unbroadcast(gq @ bq.transpose(-1, -2), aq.shape),
                _unbroadcast(aq.transpose(-1, -2) @ gq, bq.shape))


def _unbroadcast(grad: torch.Tensor, shape) -> torch.Tensor:
    """``grad`` summed over the dimensions the product broadcast to reach
    ``shape``."""
    while grad.dim() > len(shape):
        grad = grad.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and grad.shape[i] != 1:
            grad = grad.sum(i, keepdim=True)
    return grad


def fp8_matmul(a, b):
    return _Fp8Product.apply(a, b)


@contextlib.contextmanager
def no_tf32():
    """f32 products in f32: TF32 off for the reference, and back after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def leaf_norms(items) -> dict[str, float]:
    """{path: the f64 2-norm of the tensor} of (path, tensor) pairs, each
    tensor made and dropped in turn, the norms read back at once."""
    paths, norms = [], []
    for path, t in items:
        paths.append(path)
        norms.append(torch.linalg.vector_norm(t, dtype=torch.float64))
    return dict(zip(paths, torch.stack(norms).tolist()))


def job_gradient(p: dict, model: dict, batch: dict, mm, rows: int):
    """(loss, {path: gradient}) of the job's mean sequence NLL, in blocks of
    ``rows`` sequences; a leaf the loss does not use gets zeros."""
    total = batch["labels"].shape[0]
    loss = 0.0
    for lo in range(0, total, rows):
        part = {k: v[lo:lo + rows] for k, v in batch.items()}
        nll = sequence_nll(p, model, part, mm)
        (nll.sum() / total).backward()
        loss += nll.detach().sum().item() / total
    grads = {}
    for path, leaf in p.items():
        grads[path] = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        leaf.grad = None
    return loss, grads


@torch.no_grad()
def adamw(p, grads, m, v, step: int, storage: dict, lr: float, b1: float, b2: float,
          eps: float, weight_decay: float = 0.0) -> None:
    b1t = float(1.0 - np.float32(b1) ** np.float32(step))
    b2t = float(1.0 - np.float32(b2) ** np.float32(step))
    for path, leaf in p.items():
        g = grads[path]
        m[path].mul_(b1).add_(g, alpha=1 - b1)
        v[path].mul_(b2).addcmul_(g, g, value=1 - b2)
        delta = (m[path] / b1t) / (torch.sqrt(v[path] / b2t) + eps)
        if weight_decay:
            delta.add_(leaf, alpha=weight_decay)
        leaf.copy_((leaf - lr * delta).to(storage[path]).float())


def reference_run(model: dict, mix: dict, weights_of, batch_of, *, jobs: int = 3,
                  mm=torch.matmul, rows: int = 8) -> dict:
    """Jobs 1 .. ``jobs`` of the first block, job j on model (j - 1) % models,
    as the trainer interleaves them.  ``weights_of(m)`` gives model m's
    initial weights ({path: tensor}, the benchmark's), ``batch_of(j)`` job
    j's batch.  Returns {"losses": {job: loss}, "grad_norms": {model: {path:
    norm of its first gradient}}, "change_norms": {model: {path: norm of its
    parameters' change after the jobs}}}."""
    models, adam = mix["models"], mix["adam"]
    out = {"losses": {}, "grad_norms": {}, "change_norms": {}}
    with no_tf32():
        for m in range(models):
            own = [j for j in range(1, jobs + 1) if (j - 1) % models == m]
            if not own:
                continue
            start = weights_of(m)
            storage = {path: t.dtype for path, t in start.items()}
            p = {path: t.to(torch.float32, copy=True).requires_grad_(True)
                 for path, t in start.items()}
            mom = {path: torch.zeros_like(t) for path, t in p.items()}
            vel = {path: torch.zeros_like(t) for path, t in p.items()}
            for step, job in enumerate(own, start=1):
                loss, grads = job_gradient(p, model, batch_of(job), mm, rows)
                out["losses"][job] = loss
                if step == 1:
                    out["grad_norms"][m] = leaf_norms(grads.items())
                adamw(p, grads, mom, vel, step, storage, mix["lr"], adam["b1"], adam["b2"],
                      adam["eps"])
                del grads
            with torch.no_grad():
                out["change_norms"][m] = leaf_norms(
                    (path, p[path] - start[path].float()) for path in p)
            del p, mom, vel, start
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    return out
