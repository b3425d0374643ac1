"""Synthetic data pipelines.  Port of ``src/repro/data/synthetic.py``.

Two generators:
  * ``token_batch``         — language-model token streams (coded LM
    training),
  * ``classification_batch``— MNIST-like vectors + labels for the paper's
    multi-model classifier experiment (§4.2 analogue).

And the gradient-coding data plumbing:
  * ``chunk_boundaries``    — split ``d`` examples into (possibly
    unequal) chunks by fractional sizes (M-SGC's D1/D2 layout),
  * ``gc_chunked_batch``    — build the (n, s+1, chunk_bs, ...) cyclic
    replicated view consumed by the coded train step,
  * ``coded_slot_batch``    — the scheme-generic form: gather an
    arbitrary (n, slots) chunk-id grid (``scheme.chunk_slots``) over
    ``num_chunks`` equal chunks.

All generators are stateless: batch for job-t is a pure function of
(seed, job), so every worker that computes chunk-c of job-t sees the
same examples — required for GC decode exactness.  ``classification_batch``
and ``chunk_boundaries`` are numpy and give the JAX package's values
exactly; ``token_batch`` draws from a ``torch.Generator``, whose stream
differs from ``jax.random``'s, so tests hand both packages the same arrays.
"""

from __future__ import annotations

import numpy as np
import torch


def token_batch(seed: int, job: int, batch: int, seq: int, vocab: int, *, device="cpu"):
    """Deterministic (batch, seq) int64 tokens.  As in the JAX package,
    ``labels`` equals ``tokens`` (the loss shifts them by one)."""
    gen = torch.Generator().manual_seed(seed * 1_000_003 + job)
    toks = torch.randint(0, vocab, (batch, seq + 1), generator=gen)
    toks = toks[:, :-1].to(device)
    return {"tokens": toks, "labels": toks}


def classification_batch(seed: int, job: int, batch: int, dim: int = 64,
                         classes: int = 10, *, device="cpu"):
    """Separable synthetic classification data (so training visibly
    converges): class-dependent means + noise.  Returns x (batch, dim) f32
    and labels (batch,) int64."""
    rng = np.random.default_rng(seed * 100_003 + job)
    labels = rng.integers(0, classes, batch)
    protos = np.random.default_rng(seed).standard_normal((classes, dim)) * 2.0
    x = protos[labels] + rng.standard_normal((batch, dim))
    return (
        torch.from_numpy(x.astype(np.float32)).to(device),
        torch.from_numpy(labels.astype(np.int64)).to(device),
    )


def chunk_boundaries(d: int, fractions) -> list[tuple[int, int]]:
    """Integer [start, end) ranges approximating the given fractions.

    Guarantees a full partition of ``d`` (last chunk absorbs rounding)
    and at least 1 example per chunk when d >= num chunks.
    """
    fractions = np.asarray(fractions, dtype=np.float64)
    fractions = fractions / fractions.sum()
    sizes = np.maximum(np.round(fractions * d).astype(int), 1)
    # fix rounding drift
    while sizes.sum() > d:
        sizes[np.argmax(sizes)] -= 1
    sizes[-1] += d - sizes.sum()
    bounds, off = [], 0
    for s in sizes:
        bounds.append((off, off + int(s)))
        off += int(s)
    assert off == d
    return bounds


def coded_slot_batch(batch: dict, slot_chunks, num_chunks: int) -> dict:
    """Scheme-generic replicated chunk view for the coded train step.

    Splits the leading batch axis of every tensor of ``batch`` into
    ``num_chunks`` equal chunks and gathers chunk ``slot_chunks[i, j]``
    into slot (i, j), where ``slot_chunks`` is the (n, slots) int grid from
    ``scheme.chunk_slots(job)``.  Returns tensors of shape
    (n, slots, chunk_bs, ...); ``gc_chunked_batch`` is the cyclic (n, s+1)
    special case.
    """
    out = {}
    for name, leaf in batch.items():
        b = leaf.shape[0]
        if b % num_chunks:
            raise ValueError(f"batch {b} not divisible by num_chunks={num_chunks}")
        idx = torch.as_tensor(np.asarray(slot_chunks, dtype=np.int64), device=leaf.device)
        chunks = leaf.reshape(num_chunks, b // num_chunks, *leaf.shape[1:])
        out[name] = chunks[idx]  # (n, slots, cb, ...)
    return out


def gc_chunked_batch(batch: dict, n: int, s: int) -> dict:
    """Cyclic (n, s+1) replicated chunk view for the coded train step:
    slot (i, j) holds chunk ``(i + j) % n``, worker-i's (s+1) assigned
    chunks under the §3.1 placement."""
    idx = (np.arange(n)[:, None] + np.arange(s + 1)[None, :]) % n
    return coded_slot_batch(batch, idx, n)
