"""The yardstick's arithmetic, by hand at small shapes and against the
readings the repository already holds."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops
from portbench.metrics import kernel_s_per_step
from portbench.reference.model import param_spec, sequence_nll
from portbench.trace import Trace

HERE = Path(__file__).resolve().parent
CONFIGS = {name: json.loads((HERE / "configs" / f"{name}.json").read_text())["model"]
           for name in ("hubert-xlarge", "mamba2-1.3b")}
AUDIO = dict(family="audio", num_layers=2, d_model=8, num_heads=2, num_kv_heads=2, head_dim=4,
             d_ff=16, vocab_size=10, causal=False, frontend="audio_stub", dtype="bfloat16")
SSM = dict(family="ssm", num_layers=1, d_model=8, num_heads=0, num_kv_heads=0, d_ff=0,
           vocab_size=10, ssm_state=4, ssm_head_dim=4, ssm_expand=2, ssm_chunk=4,
           dtype="bfloat16")


def test_forward_ops_by_hand_audio():
    # per layer: q, k, v, o 4 x (2 s d d); the MLP 3 x (2 s d f); scores and values
    # 2 x (2 h dh s^2); the head 2 s d V
    s = 5
    layer = 4 * 2 * s * 8 * 8 + 3 * 2 * s * 8 * 16 + 2 * 2 * 2 * 4 * s * s
    assert flops.forward_ops(AUDIO, s) == 2 * layer + 2 * s * 8 * 10
    assert flops.step_ops(AUDIO, 3, s) == 3 * 3 * flops.forward_ops(AUDIO, s)
    causal = dict(AUDIO, causal=True)
    assert flops.forward_ops(AUDIO, s) - flops.forward_ops(causal, s) == \
        2 * 2 * 2 * 2 * 4 * (s * s - s * (s + 1) // 2)


def test_forward_ops_by_hand_ssm():
    # d_inner 16, state 4, 4 heads of 4; 8 positions in 2 chunks of 4 (10 causal pairs)
    s, di, st, nh, hd, Q = 8, 16, 4, 4, 4, 4
    proj = 2 * s * 8 * (2 * di + 2 * st + nh) + 2 * s * di * 8
    conv = 2 * s * 4 * (di + 2 * st)
    ssd = 2 * (2 * st * 10 + 2 * nh * hd * 10 + 2 * Q * nh * hd * st + 2 * Q * st * nh * hd
               + 2 * nh * hd * st)
    assert flops.forward_ops(SSM, s) == proj + conv + ssd + 2 * s * 8 * 10


def test_forward_ops_count_the_reference_products():
    """On a non-causal model every product the reference runs is one the
    count holds, and no other."""
    torch.manual_seed(0)
    p = {path: torch.randn(shape) * 0.1 for path, shape, _, _ in param_spec(AUDIO)}
    batch = {"frames": torch.randn(3, 5, 8), "labels": torch.randint(0, 10, (3, 5))}
    with FlopCounterMode(display=False) as counter:
        sequence_nll(p, AUDIO, batch, remat=False)
    assert counter.get_total_flops() == 3 * flops.forward_ops(AUDIO, 5)


def test_attention_bwd_work_at_hubert_gc_step():
    """PERF.md's row for the dh-80 non-causal backward at (64, 16, 500, 80):
    10 . 80 . 2.56e8 pairs of operations, 575.5 MB, 0.20708 ms bound."""
    ops, n_bytes = flops.attention_bwd_work(CONFIGS["hubert-xlarge"], 64, 500)
    assert ops == 10 * 80 * 64 * 16 * 500 * 500 == 204_800_000_000
    assert n_bytes == 2 * 64 * 500 * 80 * 7 * 16 + 4 * 64 * 16 * 500 == 575_488_000
    assert flops.bound_s(ops, n_bytes) * 1e3 == pytest.approx(0.20708, abs=1e-5)


def test_attention_bwd_work_gqa_by_hand():
    model = dict(AUDIO, num_heads=4, num_kv_heads=2, head_dim=2, causal=True)
    ops, n_bytes = flops.attention_bwd_work(model, 1, 3)
    assert ops == 10 * 2 * 4 * 6
    assert n_bytes == 2 * 3 * 2 * (3 * 4 + 4 * 2) + 4 * 4 * 3


def test_ssd_bwd_work_at_mamba2_gc_step():
    """PERF.md's row for the SSD backward at GC's 128 x 256 tokens, (512, 64,
    64, 64, 128) in bf16: a 0.90146 ms bound, by its bytes."""
    ops, n_bytes = flops.ssd_bwd_work(CONFIGS["mamba2-1.3b"], 128, 256)
    assert n_bytes / flops.PEAK_BYTES > ops / flops.PEAK_BF16_OPS
    assert flops.bound_s(ops, n_bytes) * 1e3 == pytest.approx(0.90146, abs=1e-5)


def test_launch_formula_is_chip_smokes():
    """The formula copied from ``chip_smoke._per_step`` gives what it gives."""
    chip_smoke = pytest.importorskip("chip_smoke")
    from repro_torch.configs import get_config

    for name, model in CONFIGS.items():
        assert flops.launches_per_step(model) == chip_smoke._per_step(get_config(name))


class _Ctx:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _ctx(per_job, kernels, wall=2.0, jobs=4):
    model = CONFIGS["hubert-xlarge"]
    return _Ctx(model=model, mix={"seq_len": 500}, seqs=48,
                window={"wall_s": wall, "jobs": jobs, "step_s": 1.5, "blocks": 1},
                trace=Trace(window_s=1.0, busy_s=0.9, activities=10, kernels=kernels),
                launches={"jobs": 4, "per_job": per_job,
                          "formula": flops.launches_per_step(model)})


def test_step_mfu_and_attention_roofline_readers():
    from portbench.metrics import read

    want = flops.launches_per_step(CONFIGS["hubert-xlarge"])
    # 48 calls a step; the profiler lost one dq launch of the 192: means per launch
    kernels = {"attn_bwd_dq_bf16_kernel<80>": [191, 191 * 1e-3],
               "attn_bwd_dkdv_bf16_kernel<80>": [192, 192 * 0.5e-3], "gemm": [5, 1.0]}
    ctx = _ctx(dict(want), kernels)
    ops = flops.step_ops(ctx.model, 48, 500)
    assert read("step_mfu", ctx) == pytest.approx(100 * ops / (1.5 / 4) / 989e12)
    assert kernel_s_per_step(ctx, "flash_attention_bwd", ("attn_bwd_dq", "attn_bwd_dkdv")) == \
        pytest.approx(48 * 1.5e-3)
    work = flops.attention_bwd_work(ctx.model, 48, 500)
    assert read("attn_bwd_roofline", ctx) == pytest.approx(
        100 * flops.bound_s(*work) / 1.5e-3)
    assert read("host_ms_per_job", ctx) == pytest.approx(125.0)
    assert read("device_idle_share", ctx) == pytest.approx(10.0)
    # a step that took another path than the formula's: nothing to read
    assert read("attn_bwd_roofline", _ctx(dict(want, flash_attention_bwd=47), kernels)) is None
    assert read("attn_bwd_roofline", _ctx(dict(want), {"gemm": [5, 1.0]})) is None


def test_a_listed_metric_that_reads_nothing_refuses_the_run():
    """A per-layer metric the cell lists that reads nothing stops the run
    (no result line), where it would otherwise drop out of the line unseen."""
    from portbench import harness, spec

    cell = spec.load_cell("hubert-xlarge.gc-f500")
    want = flops.launches_per_step(CONFIGS["hubert-xlarge"])
    kernels = {"attn_bwd_dq_bf16_kernel<80>": [192, 0.2], "attn_bwd_dkdv_bf16_kernel<80>":
               [192, 0.1]}
    ctx = _ctx(dict(want), kernels)
    ctx.cell = cell
    ctx.trace.ranges["portbench.adamw"] = 0.2
    out = harness._per_layer(cell, ctx, print)
    assert set(out) == {m["name"] for m in cell.per_layer}
    del ctx.trace.ranges["portbench.adamw"]        # the optimizer ran outside the range
    with pytest.raises(harness.Unread, match="adamw_ms_per_step"):
        harness._per_layer(cell, ctx, print)
    ctx.trace.ranges["portbench.adamw"] = 0.2
    ctx.window["step_s"] = 0.0                     # no span around the coded step
    with pytest.raises(harness.Unread, match="host_ms_per_job, step_mfu"):
        harness._per_layer(cell, ctx, print)
