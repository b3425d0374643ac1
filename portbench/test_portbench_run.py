"""A run rehearsed on the CPU at a tiny size: the harness drives the program
and the check as on the card, reports no metric, and ``correct`` comes out
true on a sound run and false with each fault a training cell can have
planted under the timed path.  And ``run.py`` without a card refuses."""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import harness, spec
from portbench.reference import compare

HERE = Path(__file__).resolve().parent
TINY = {
    "hubert-xlarge.gc-f500": (dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                                     head_dim=16, d_ff=128, vocab_size=32), dict(seq_len=16)),
    "mamba2-1.3b.gc-t256": (dict(num_layers=2, d_model=64, vocab_size=64, ssm_state=16,
                                   ssm_head_dim=16, ssm_chunk=8), dict(seq_len=32)),
}
SEED = 2 ** 31 + 977
#: limits at the tiny size, where a leaf's norm sums a few hundred elements and
#: reads noisier than at the cells' widths; set from 13 seeds of M-SGC (whose
#: decode weights amplify rounding: the GC cells read less) on the CPU: the
#: program read at most loss 1.8e-4, grad 0.013 (median leaf 0.0013), update
#: 0.15 (mamba2's dt_bias), decode 1.4e-6; the fp8 control at least loss
#: 4.4e-4, grad 0.0094 (median leaf 0.0028), update 0.0083
TINY_LIMITS = {"loss_gap": 3.5e-4, "grad_gap": 0.05, "grad_gap_median": 0.0025,
               "update_gap": 0.3, "decode_gap": 1e-4}


def tiny_cell(name: str, limits=None):
    """The cell at a size the CPU holds: its scheme, workers, models, job batch
    and dtype, narrower and shallower, shorter sequences; ``limits`` in place
    of its own where given."""
    cell = spec.load_cell(name)
    model, mix = TINY[name]
    config = dict(cell.config, model={**cell.config["model"], **model})
    return dataclasses.replace(cell, config=config, mix={**cell.mix, **mix},
                               limits=limits or cell.limits)


def rehearse(name, fault=None, trace=False, limits=TINY_LIMITS):
    lines = []
    result = harness.run(tiny_cell(name, limits), SEED, 0.2, trace, "cpu",
                         time.perf_counter(), fault=fault, log=lines.append)
    return result, lines


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_sound_run_is_correct_and_reports_no_card_metric(name, trace):
    result, lines = rehearse(name, trace=trace)
    assert result["correct"], result["compared"]
    assert result["metrics"] == {} and "device" not in result and "breakdown" not in result
    assert list(result)[-1] == "compared"
    assert result["attempted"] >= 4 and result["failed"] == 0
    assert set(result["compared"]) == set(TINY_LIMITS)
    assert lines[0].startswith("set-up")


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("fault", harness.FAULTS)
def test_a_planted_fault_is_not_correct(name, fault):
    """Under the cell's own limits and under the tiny size's."""
    for limits in (None, TINY_LIMITS):
        result, _ = rehearse(name, fault=fault, limits=limits)
        assert not result["correct"], result["compared"]


@pytest.mark.parametrize("name", sorted(TINY))
def test_the_fp8_control_is_not_correct(name):
    """The reference in the program's place, its products in fp8, fails a
    number where the program passes them all."""
    cell = tiny_cell(name)
    model, mix = cell.config["model"], cell.mix
    ref = harness.reference_readings(model, mix, SEED, "cpu")
    control = compare.numbers(harness.reference_readings(model, mix, SEED, "cpu", control=True),
                              ref)
    limits = {k: v for k, v in TINY_LIMITS.items() if k in control}
    assert not compare.judge(control, limits)[0], control


def test_decode_gap_reads_the_view_the_step_was_fed():
    import torch

    batch = {"labels": torch.arange(24).reshape(4, 6), "frames": torch.randn(4, 6, 2)}
    slots = torch.tensor([[0, 1], [1, 2], [2, 3], [3, 0]])
    coded = {k: v.reshape(4, 1, *v.shape[1:])[slots].squeeze(2) for k, v in batch.items()}
    coded = {k: v.unsqueeze(2) for k, v in coded.items()}     # (n, slots, cb 1, ...)
    ids = harness.chunk_ids(coded, batch, 4)
    assert ids.tolist() == slots.tolist()
    assert harness.decode_gap(torch.full((4, 2), 0.5), ids, 4) == 0.0
    assert harness.decode_gap(torch.tensor([[1.0, 0], [1, 0], [1, 0], [0, 0]]), ids, 4) == 1.0
    coded["frames"][0, 0] += 1          # a slot whose frames are no chunk's
    ids = harness.chunk_ids(coded, batch, 4)
    assert ids[0, 0] == -1
    assert harness.decode_gap(torch.full((4, 2), 0.5), ids, 4) == 0.5


def test_run_refuses_without_a_card(tmp_path):
    """No card: exit 1 and no line on standard output."""
    proc = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                           "hubert-xlarge.gc-f500", "--seed", str(SEED), "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, timeout=120,
                          cwd=tmp_path)
    assert proc.returncode == 1 and proc.stdout == ""
    assert "no result" in proc.stderr


def test_run_refuses_an_unknown_cell(tmp_path):
    proc = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "nothing.here",
                           "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                          timeout=120, cwd=tmp_path)
    assert proc.returncode == 1 and proc.stdout == ""


def test_forbidden_modules_are_whole_top_level_names():
    import importlib.util

    spec_ = importlib.util.spec_from_file_location("portbench_run_cli", HERE / "run.py")
    run = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(run)
    assert run.forbidden_modules(["repro_torch", "repro_torch.train", "torch"]) == []
    assert run.forbidden_modules(["repro_torch", "repro.core", "jaxlib.xla", "flax"]) == [
        "flax", "jaxlib", "repro"]


def test_the_result_line_is_json():
    result, _ = rehearse("hubert-xlarge.gc-f500")
    assert json.loads(json.dumps(result)) == result


def test_the_optimizer_range_refuses_a_step_that_bypasses_it():
    """``adamw_range`` sees each coded step's ``adamw_update`` call; a step
    that reaches its optimizer another way stops the traced run."""
    from repro_torch.train import coded

    program = coded.adamw_update
    with harness.adamw_range(lambda: 0):
        assert coded.adamw_update is not program
    assert coded.adamw_update is program
    with pytest.raises(harness.Unread, match="called 0 times in 2 coded steps"):
        with harness.adamw_range(lambda: 2):
            pass
    assert coded.adamw_update is program
