"""Numeric protocol executor: runs a scheme against actual per-chunk
partial gradients and checks the master's decode is *exactly* the full
gradient.  This is the machine-checkable form of Props 3.1 / 3.2 and is
reused by the coded trainer's unit tests.  Port of
``src/repro/core/executor.py``.

Cluster-structured codes (dc-gc / sb-gc) need no special casing here:
their ``scheme.code`` adapter exposes the round's embedded (n, n)
encode matrix, ``collect`` emits per-cluster decode vectors as plain
``ell_weights``, and the generic "ell" task/decode branches below do
the rest — so the same harness that certifies GC certifies the
clustered baselines (``tests/test_exact_decode.py`` sweeps them over
all conforming small-n patterns).
"""

from __future__ import annotations

import numpy as np

from .schemes import JobDecode, MSGCScheme, Scheme
from .straggler import ConformanceGate, StragglerModel

__all__ = ["run_protocol", "conforming_pattern", "decode_from_results"]


def run_protocol(
    scheme: Scheme,
    pattern: np.ndarray,
    *,
    dim: int = 4,
    seed: int = 0,
    atol: float = 1e-6,
) -> dict[int, np.ndarray]:
    """Execute J jobs under ``pattern`` (bool[rounds, n], conforming to the
    scheme's design model) and return {job: decoded gradient}.

    Partial gradients are random vectors; for every decoded job we assert
    ``decoded == sum over chunks of g_c(job)``.
    """
    n, J = scheme.n, scheme.J
    rounds = J + scheme.T
    if pattern.shape[0] < rounds:
        raise ValueError("pattern too short")
    rng = np.random.default_rng(seed)

    num_chunks = scheme.num_chunks if isinstance(scheme, MSGCScheme) else n
    partials = rng.standard_normal((J + 1, num_chunks, dim))  # [job, chunk, dim]
    truth = partials.sum(axis=1)  # g(job) = sum_c g_c(job)

    results: dict[tuple, np.ndarray] = {}
    decoded: dict[int, np.ndarray] = {}

    for t in range(1, rounds + 1):
        tasks = scheme.assign(t)
        strag = pattern[t - 1]
        for mt in tasks:
            if mt.trivial or strag[mt.worker]:
                continue
            if mt.kind == "ell":
                row = scheme.code.encode_matrix[mt.worker]
                sup = np.flatnonzero(row)
                val = row[sup] @ partials[mt.job, sup]
                results[("ell", mt.job, mt.worker)] = val
            elif mt.kind == "d1":
                results[("d1", mt.job, mt.chunk)] = partials[mt.job, mt.chunk]
            elif mt.kind == "d2":
                m = mt.chunk
                base = (scheme.W - 1) * scheme.n + m * scheme.n
                coeffs = scheme.code.encode_matrix[mt.worker]
                loc = np.flatnonzero(coeffs)  # local chunk ids within group
                val = coeffs[loc] @ partials[mt.job, base + loc]
                results[("d2", mt.job, m, mt.worker)] = val
            elif mt.kind == "all":
                results[("d1", mt.job, mt.chunk)] = partials[mt.job, mt.chunk]
        scheme.observe(t, strag)
        for jd in scheme.collect(t):
            decoded[jd.job] = decode_from_results(scheme, jd, results)
            np.testing.assert_allclose(
                decoded[jd.job], truth[jd.job], atol=atol,
                err_msg=f"job {jd.job} decode mismatch",
            )

    missing = [j for j in range(1, J + 1) if j not in decoded]
    if missing:
        raise AssertionError(f"jobs never decoded: {missing}")
    return decoded


def decode_from_results(
    scheme: Scheme, jd: JobDecode, results: dict, *, job: int | None = None
) -> np.ndarray:
    """Reconstruct job ``jd.job``'s full gradient from per-task result
    vectors keyed executor-style (``("ell", job, worker)`` /
    ``("d1", job, chunk)`` / ``("d2", job, m, worker)``).  Shared by the
    in-process protocol check above and the ``repro.dist`` master, which
    feeds it vectors computed by real worker processes.

    ``job`` overrides the job id used in the result keys: the elastic
    master's degraded epochs run a *fresh* scheme whose local job
    numbering (1..J') maps onto the original job ids the workers
    compute and key their results with."""
    j = jd.job if job is None else job
    if jd.ell_weights:  # GC / SR-SGC / clustered
        return sum(
            w * results[("ell", j, i)] for i, w in jd.ell_weights.items()
        )
    if isinstance(scheme, MSGCScheme):
        total = sum(
            results[("d1", j, scheme.d1_chunk(i, l))]
            for i in range(scheme.n)
            for l in range(scheme.W - 1)
        )
        for m, weights in jd.group_weights.items():
            total = total + sum(
                w * results[("d2", j, m, i)] for i, w in weights.items()
            )
        return total
    # uncoded
    return sum(results[("d1", j, c)] for c in range(scheme.n))


def conforming_pattern(
    model: StragglerModel,
    rounds: int,
    n: int,
    *,
    seed: int = 0,
    density: float = 0.25,
) -> np.ndarray:
    """Random pattern guaranteed to conform to ``model``.

    Greedy construction mirroring the Remark-2.3 gate: sample candidate
    straggler rows, drop workers until the incremental check admits the
    row.  Stresses schemes far better than all-zeros.
    """
    rng = np.random.default_rng(seed)
    gate = ConformanceGate(model, n)
    for _ in range(rounds):
        cand = rng.random(n) < density
        while cand.any() and not gate.admit(cand):
            on = np.flatnonzero(cand)
            cand[rng.choice(on)] = False
        if not cand.any():
            gate.force(cand)
    assert model.conforms(gate.history)
    return gate.history
