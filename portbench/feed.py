"""The one generator of every traffic mix: the straggler delays of each block
of jobs and each job's batch, drawn from ``--seed`` alone.

A mix (``traffic/<mix>.json``) gives the scheme and its parameters, the
workers, the interleaved models, the job batch and its sequence length, the
input kind (``frames``: seeded frame embeddings and a label a frame, the
stubbed audio frontend's output; ``tokens``: seeded token ids, their own
labels), the jobs of a block and the Gilbert-Elliott chain of the
stragglers.  Every block has the same jobs and sizes, whatever the seed: a
seed changes which worker straggles when and the values in the batches,
never the work.
"""

from __future__ import annotations

import hashlib

import numpy as np


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one stream (weights of a model, a block's delays, a
    job's batch), a function of ``seed`` and the stream's tags alone."""
    digest = hashlib.blake2b(repr((int(seed),) + tags).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & (2 ** 63 - 1)


def ge_delays(n: int, rounds: int, seed: int, *, p_ns: float, p_sn: float,
              base_time: float, slow_factor: float, jitter: float) -> np.ndarray:
    """(rounds, n) round times of a two-state Gilbert-Elliott chain per worker
    (the paper's App. C): a non-straggler takes ``base_time * (1 + jitter *
    z**2)``, a straggler that times a uniform factor in [1, slow_factor].
    The draws follow the order of ``GilbertElliotSource.sample_delays`` of
    both packages."""
    rng = np.random.default_rng(seed)
    state = rng.random(n) < p_ns / (p_ns + p_sn)
    flips = rng.random((rounds, n))
    pattern = np.zeros((rounds, n), dtype=bool)
    for t in range(rounds):
        pattern[t] = state
        state = np.where(state, flips[t] >= p_sn, flips[t] < p_ns)
    rng = np.random.default_rng(seed + 1)
    base = base_time * (1.0 + jitter * rng.standard_normal((rounds, n)) ** 2)
    slow = 1.0 + (slow_factor - 1.0) * rng.random((rounds, n))
    return np.where(pattern, base * np.maximum(slow, 1.0), base)


def block_delays(mix: dict, seed: int, block: int, rounds: int) -> np.ndarray:
    ge = mix["stragglers"]
    return ge_delays(mix["n"], rounds, sub_seed(seed, "delays", block), **ge)


def job_batch(mix: dict, model: dict, seed: int, block: int, job: int, device, dtype):
    """Job ``job`` of block ``block``: a dict of (job_batch, seq_len, ...)
    tensors on ``device``, drawn there by one generator.  Frames come in
    ``dtype``, the configuration's (the frontend's output as the model takes
    it)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "batch", block, job))
    shape = (mix["job_batch"], mix["seq_len"])
    if mix["input"] == "frames":
        frames = torch.randn(shape + (model["d_model"],), generator=gen, device=device,
                             dtype=dtype)
        labels = torch.randint(0, model["vocab_size"], shape, generator=gen, device=device)
        return {"frames": frames, "labels": labels}
    if mix["input"] == "tokens":
        tokens = torch.randint(0, model["vocab_size"], shape, generator=gen, device=device)
        return {"tokens": tokens, "labels": tokens}
    raise ValueError(f"unknown input kind {mix['input']!r}")


def tokens_per_job(mix: dict) -> int:
    """What a decoded job trains on: its batch's sequences times their length
    (a frame with its label counts as a token)."""
    return mix["job_batch"] * mix["seq_len"]
