"""The frozen reference against the port's plain path, on the CPU at the
smoke sizes in f32: the same weights (the benchmark's, loaded into the
port's tree), the same batches; each sequence's loss, the job's gradient and
an AdamW step agree to rounding."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from portbench import feed
from portbench.reference.model import sequence_nll
from portbench.reference.train import adamw, job_gradient
from portbench.weights import load_into, make_weights, tree_paths

HERE = Path(__file__).resolve().parent
SMOKE = {
    "hubert-xlarge": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
                          d_ff=128, vocab_size=32, dtype="float32"),
    "mamba2-1.3b": dict(num_layers=2, d_model=64, vocab_size=64, ssm_state=16, ssm_head_dim=16,
                        ssm_chunk=8, dtype="float32"),
}
MIX = {"hubert-xlarge": dict(job_batch=4, seq_len=12, input="frames"),
       "mamba2-1.3b": dict(job_batch=4, seq_len=20, input="tokens")}   # a padded last chunk


def _setup(name):
    from repro_torch.models import init_params
    from repro_torch.models.config import ModelConfig

    model = {**json.loads((HERE / "configs" / f"{name}.json").read_text())["model"],
             **SMOKE[name]}
    cfg = ModelConfig(**model)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    load_into(params, make_weights(model, 7, 0, "cpu"))
    batch = feed.job_batch(MIX[name], model, 7, 0, 1, "cpu", torch.float32)
    return model, cfg, params, batch


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_reference_loss_and_gradient_match_the_ports_plain_path(name):
    from repro_torch.models import token_nll
    from repro_torch.train.coded import value_and_grad

    model, cfg, params, batch = _setup(name)
    ref = {p: t.clone().requires_grad_(True) for p, t in tree_paths(params)}
    with torch.no_grad():
        want = token_nll(params, cfg, batch, plain=True)[0].mean(dim=1)
        got = sequence_nll(ref, model, batch)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)

    loss, grads = value_and_grad(
        lambda p: token_nll(p, cfg, batch, plain=True)[0].mean(dim=1).mean(), params)
    ref_loss, ref_grads = job_gradient(ref, model, batch, torch.matmul, rows=3)
    assert ref_loss == pytest.approx(loss.item(), rel=1e-6)
    for path, g in tree_paths(grads):
        torch.testing.assert_close(ref_grads[path], g, rtol=1e-4, atol=1e-6, msg=path)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reference_adamw_is_the_ports(dtype):
    from repro_torch.optim import adamw_init, adamw_update

    gen = torch.Generator().manual_seed(3)
    params = {"w": torch.randn(64, 8, generator=gen).to(dtype)}
    grads = [{"w": torch.randn(64, 8, generator=gen)} for _ in range(3)]
    state = adamw_init(params)
    p = {"w": params["w"].float()}
    m, v = {"w": torch.zeros(64, 8)}, {"w": torch.zeros(64, 8)}
    for step, g in enumerate(grads, start=1):
        params, state = adamw_update(params, {"w": g["w"].to(dtype)}, state, lr=1e-3)
        adamw(p, {"w": g["w"].to(dtype).float()}, m, v, step, {"w": dtype}, 1e-3, 0.9, 0.999,
              1e-8)
        torch.testing.assert_close(p["w"], params["w"].float(), rtol=0, atol=0)
        torch.testing.assert_close(m["w"], state.m["w"], rtol=0, atol=0)


def test_grad_gap_kind_sees_a_kernel_output_off_in_every_layer():
    """A kind of leaf off by 30% in every layer reads 0.3 of its share; one
    layer's leaf far off, as rounding puts it, leaves the kind's median."""
    from portbench.reference import compare

    ref = {"embed": 1.0}
    for i in range(48):
        ref |= {f"layers.{i}.ssm.in_proj": 1.0, f"layers.{i}.ssm.D": 2.0,
                f"layers.{i}.ssm.A_log": 0.5}
    program = {"grad_norms": {0: dict(ref)}, "change_norms": {0: dict(ref)},
               "losses": {1: 1.0}}
    reference = {"grad_norms": {0: ref}, "change_norms": {0: ref}, "losses": {1: 1.0}}
    assert compare.numbers(program, reference)["grad_gap_kind"] == 0
    program["grad_norms"][0]["layers.7.ssm.D"] = 2.0 * 1.5
    found = compare.numbers(program, reference)
    assert found["grad_gap"] == pytest.approx(0.5) and found["grad_gap_kind"] == 0
    for i in range(48):
        program["grad_norms"][0][f"layers.{i}.ssm.D"] = 2.0 * 1.3
        program["grad_norms"][0][f"layers.{i}.ssm.A_log"] = 0.5 * 1.3
    kinds = compare.kind_gaps(dict(zip(ref, compare.leaf_gaps(program["grad_norms"][0], ref))))
    assert kinds["layers.ssm.D"] == pytest.approx(0.3)
    assert kinds["layers.ssm.A_log"] == pytest.approx(0.3 * 0.5)   # against the median leaf, 1
    assert kinds["layers.ssm.in_proj"] == 0 and "embed" not in kinds
    assert compare.numbers(program, reference)["grad_gap_kind"] == pytest.approx(0.3)
