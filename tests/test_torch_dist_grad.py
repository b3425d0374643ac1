"""Grad-mode workers of the port's harness against the JAX package's.

In process, on the CPU, in f32: the reference's parameters (drawn from its
``PRNGKey``) and token batch handed to the port's ``TaskComputer`` through
``convert.params_from_jax``; its ``chunk_grad``, ``value`` and ``full_grad``
equal the reference's within ``GRAD_TOL`` — the two packages sum the same
f32 terms in other orders (autograd against ``jax.grad``, a matmul for the
coded combine), so entries agree to ~1e-6 of the gradient's scale, and
``tests/test_torch_train.py`` holds gradients to the same atol 2e-5 / rtol
2e-3.  The flat vector follows ``jax.flatten_util.ravel_pytree``'s layout
(sorted keys, the stacked layers layer-major), so it is compared element by
element.  Then one spawned grad-mode ``run_harness`` at a tiny width on the
CPU, the no-card refusal, the contract linter over the port's harness, and
the card's tests (``-m cuda``).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
from repro_torch.convert import params_from_jax
from repro_torch.core import GilbertElliotSource, make_scheme
from repro_torch.dist import HarnessConfig, TaskComputer, run_harness
from repro_torch.dist.worker import ravel_into, reference_leaves

ROOT = Path(__file__).resolve().parents[1]
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)
TINY = dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=1, head_dim=16, d_ff=64,
            vocab_size=64)
BATCH, SEQ, SEED = 12, 8, 1
BOUNDS = [(0, 4), (4, 8), (8, 12)]


@pytest.fixture(scope="module")
def pair():
    """(reference TaskComputer, port TaskComputer on the CPU holding the
    reference's parameters and batch for jobs 1 and 2)."""
    import jax

    from repro.configs.qwen2_0_5b import SMOKE
    from repro.dist.worker import TaskComputer as RefComputer

    want = RefComputer(SEED, "grad", 8, BATCH, BOUNDS, model_cfg=SMOKE.replace(**TINY),
                       batch_size=BATCH, seq_len=SEQ)
    cfg = tcfgs.get_smoke("qwen2-0.5b").replace(**TINY)
    got = TaskComputer(SEED, "grad", 8, BATCH, BOUNDS, model_cfg=cfg, batch_size=BATCH,
                       seq_len=SEQ, device="cpu")
    for job in (1, 2):
        params, batch = want._grad_data(job)
        got._jobs[job] = (
            params_from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu"),
            {k: torch.from_numpy(np.array(v)).long() for k, v in batch.items()},
        )
    return want, got


def test_ravel_order_is_the_reference(pair):
    """Each JAX leaf's slice of the flat vector holds that leaf, stacked
    layers layer-major: the port's vector of the reference's parameters is
    ``ravel_pytree`` of them."""
    import jax
    from jax.flatten_util import ravel_pytree

    want, got = pair
    jparams, _ = want._grad_data(1)
    flat = torch.empty(sum(t.numel() for g in reference_leaves(got._jobs[1][0]) for t in g))
    ravel_into(flat, got._jobs[1][0])
    np.testing.assert_array_equal(flat.numpy(), np.asarray(ravel_pytree(jparams)[0]))
    assert len(reference_leaves(got._jobs[1][0])) == len(jax.tree.leaves(jparams))


def test_chunk_grad_value_and_full_grad_equal_the_reference(pair):
    want, got = pair
    for job in (1, 2):
        for c in range(len(BOUNDS)):
            g = got.chunk_grad(job, c)
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, want.chunk_grad(job, c), **GRAD_TOL)
        np.testing.assert_allclose(got.full_grad(job), want.full_grad(job), **GRAD_TOL)
    # a GC row (k = 2), a d1 part (k = 1) and a three-chunk combination
    for item in ({"job": 1, "chunks": [0, 1], "coeffs": [1.0, -1.0]},
                 {"job": 2, "chunks": [2], "coeffs": [1.0]},
                 {"job": 2, "chunks": [0, 1, 2], "coeffs": [0.5, 2.0, -1.5]}):
        v = got.value(item)
        assert v.dtype == np.float32
        np.testing.assert_allclose(v, want.value(item), **GRAD_TOL)
    # the chunks' gradients add up to the full-batch gradient
    total = sum(got.chunk_grad(1, c) for c in range(len(BOUNDS)))
    np.testing.assert_allclose(total, got.full_grad(1), **GRAD_TOL)


def test_spawned_grad_mode_run_on_the_cpu_decodes_every_job():
    n, J = 3, 2
    cfg = tcfgs.get_smoke("qwen2-0.5b").replace(**TINY)
    delays = GilbertElliotSource(n=n, seed=4, p_ns=0.15, p_sn=0.5, slow_factor=5.0,
                                 jitter=0.05).sample_delays(J + 2)
    res = run_harness("gc", n, J, delays, params={"s": 1}, config=HarnessConfig(
        alpha=8.0, time_scale=0.01, seed=1, compute="grad", model_cfg=cfg,
        batch_size=BATCH, seq_len=SEQ, device="cpu", round_timeout=20.0,
        decode_atol=1e-3))
    assert not res.aborted, res.abort_reason
    assert sorted(res.decoded_jobs) == list(range(1, J + 1))
    assert res.decode_max_err < 1e-4
    assert res.ledger.rounds == J + make_scheme("gc", n, J, s=1).T
    assert all(st.compute_s > 0 for rec in res.ledger.records for st in rec.stats
               if st.compute_s is not None)


def test_grad_mode_without_a_card_raises_before_spawning(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import repro_torch.dist.supervisor as sup

    def no_spawn(*a, **kw):
        raise AssertionError("a worker was spawned")

    monkeypatch.setattr(sup, "start_worker", no_spawn)
    cfg = tcfgs.get_smoke("qwen2-0.5b").replace(**TINY)
    delays = np.ones((4, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_harness("gc", 3, 2, delays, params={"s": 1}, config=HarnessConfig(
            compute="grad", model_cfg=cfg, batch_size=BATCH, seq_len=SEQ))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TaskComputer(SEED, "grad", 8, BATCH, BOUNDS, model_cfg=cfg, batch_size=BATCH,
                     seq_len=SEQ)


def test_contract_linter_is_clean_on_the_ports_harness():
    """The JAX package's linter (``repro.analysis``), its rules scoped to the
    port's ``dist/``, ``checkpoint/`` and ``core/executor.py``: no
    violation, every suppression used."""
    import copy

    from repro.analysis import run_analysis
    from repro.analysis.config import DEFAULT_CONFIG

    rules = ("unsafe-deserialization", "protocol-exhaustiveness", "blanket-except",
             "determinism")
    config = {rule: copy.deepcopy(DEFAULT_CONFIG[rule]) for rule in rules}
    config["suppression-syntax"] = {"files": ["src/repro_torch/dist/*.py",
                                              "src/repro_torch/checkpoint/*.py",
                                              "src/repro_torch/core/executor.py"]}
    config["unsafe-deserialization"].update(
        files=["src/repro_torch/checkpoint/*.py", "src/repro_torch/dist/*.py"],
        ban_under=["src/repro_torch/checkpoint/"], wire_under=["src/repro_torch/dist/"])
    config["blanket-except"]["files"] = ["src/repro_torch/core/executor.py",
                                         "src/repro_torch/dist/*.py"]
    config["protocol-exhaustiveness"]["files"] = [
        f"src/repro_torch/dist/{m}.py" for m in ("master", "worker", "supervisor",
                                                 "transport", "net")]
    config["determinism"].update(files=["src/repro_torch/core/executor.py"],
                                 no_clock_under=["src/repro_torch/core/"],
                                 monotonic_only_under=[])
    report = run_analysis(ROOT, config)
    assert report.violations == [], [v.format() for v in report.violations]
    assert report.unused_suppressions == []
    assert {"src/repro_torch/dist/net.py", "src/repro_torch/checkpoint/io.py",
            "src/repro_torch/core/executor.py"} <= set(report.checked_files)
    assert any(v.rule == "protocol-exhaustiveness" for v, _ in report.suppressed)


# -- on the card -------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_card_values_launch_one_combine_and_match_the_cpu(cuda_device):
    """The card's TaskComputer on the CPU's parameters and batches: one
    ``coded_combine`` launch an item, values and the full-batch gradient
    within ``GRAD_TOL`` of the CPU's."""
    from repro_torch.kernels.gc_coding.gc_coding import coded_combine

    cfg = tcfgs.get_smoke("qwen2-0.5b")      # head dim 32: the kernels' least
    cpu = TaskComputer(SEED, "grad", 8, BATCH, BOUNDS, model_cfg=cfg, batch_size=BATCH,
                       seq_len=SEQ, device="cpu")
    card = TaskComputer(SEED, "grad", 8, BATCH, BOUNDS, model_cfg=cfg, batch_size=BATCH,
                        seq_len=SEQ, device="cuda")
    for job in (1, 2):
        params, batch = cpu._grad_data(job)
        card._jobs[job] = (_to(params, cuda_device),
                           {k: v.to(cuda_device) for k, v in batch.items()})
    for item in ({"job": 1, "chunks": [0, 1], "coeffs": [1.0, -1.0]},
                 {"job": 2, "chunks": [2], "coeffs": [1.0]}):
        before = coded_combine.launches
        v = card.value(item)
        assert coded_combine.launches == before + 1
        np.testing.assert_allclose(v, cpu.value(item), **GRAD_TOL)
    np.testing.assert_allclose(card.full_grad(1), cpu.full_grad(1), **GRAD_TOL)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)
