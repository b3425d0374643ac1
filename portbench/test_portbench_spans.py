"""The pass over the program's own spans (``spans.py``) on synthetic profiler
events and on a CPU profile of a coded job: phases, model spans through the
autograd join, idle time by span; and what the program's ranges do to the
traced block's first reduction (``trace.reduce``)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench.spans import (BACKWARD_NODE, PHASES, master_ms_per_job, program_pass, readings,
                             split_events, tables)
from portbench.trace import WINDOW, breakdown, reduce

BACKWARD_HEAD = BACKWARD_NODE + "LogSoftmaxBackward0"
BACKWARD_ATTN = BACKWARD_NODE + "MmBackward0"

# main thread 1, the autograd engine's thread 2; runtime calls "cuLaunch" (their
# correlation ids are the device activities'), one device activity a call
PROGRAM_CPU = [
    (WINDOW, 0, 200, 1, 0),
    ("train.round", 1, 199, 1, 0),
    ("train.batch", 2, 8, 1, 0),
    ("cuLaunch", 3, 4, 1, 1),                       # the feed: outside
    ("train.step", 10, 190, 1, 0),
    ("step.forward", 10, 60, 1, 0),
    ("model.attention", 12, 30, 1, 0),
    ("cuLaunch", 14, 15, 1, 2),                     # forward, attention
    ("model.head", 40, 55, 1, 0),
    ("cuLaunch", 42, 43, 1, 3),                     # forward, head
    ("cuLaunch", 57, 58, 1, 4),                     # forward, no model span
    ("step.backward", 62, 150, 1, 0),
    (BACKWARD_HEAD, 64, 80, 2, 0),
    ("cuLaunch", 66, 67, 2, 5),                     # backward of the head's node
    (BACKWARD_ATTN, 82, 140, 2, 0),
    ("model.attention", 84, 100, 2, 0),             # the layer run again in the node
    ("cuLaunch", 86, 87, 2, 6),                     # recompute
    ("cuLaunch", 110, 111, 2, 7),                   # backward of the attention's node
    ("cuLaunch", 145, 146, 1, 8),                   # backward, main thread, no node
    ("step.optimizer", 152, 188, 1, 0),
    ("cuLaunch", 154, 155, 1, 9),                   # optimizer
    ("train.loss_read", 191, 198, 1, 0),
]
# (name, start, end, thread, sequence_nr, forward thread): the forward ops and the
# backward nodes, which name their forward op by (forward thread, sequence_nr)
PROGRAM_OPS = [("aten::mm", 14, 15, 1, 7, 0), ("aten::log_softmax", 42, 43, 1, 9, 0),
               ("aten::view", 41, 41.5, 1, 9, 0), ("aten::mm", 86, 87, 2, 3, 0),
               (BACKWARD_HEAD, 64, 80, 2, 9, 1), (BACKWARD_ATTN, 82, 140, 2, 7, 1)]
PROGRAM_DEVICE = [(f"k{c}", 5 + 20 * (c - 1), 15 + 20 * (c - 1), c) for c in range(1, 10)]
US = 10e-6                                          # each activity lasts 10 us


def _program():
    return program_pass(PROGRAM_DEVICE, PROGRAM_CPU, PROGRAM_OPS)


def test_phases_and_model_spans():
    p = _program()
    assert p.phases == pytest.approx({"outside": US, "forward": 3 * US, "backward": 3 * US,
                                      "recompute": US, "optimizer": US})
    assert p.outside == 1
    assert p.busy_s == pytest.approx(9 * US) and p.window_s == pytest.approx(200e-6)
    assert p.by_model == pytest.approx({
        ("", "outside"): US, ("model.attention", "forward"): US, ("model.head", "forward"): US,
        ("", "forward"): US,
        ("model.head", "backward"): US,             # joined to aten::log_softmax (1, 9)
        ("model.attention", "recompute"): US,       # its own thread's span
        ("model.attention", "backward"): US,        # joined to the forward's aten::mm (1, 7)
        ("", "backward"): US, ("", "optimizer"): US})
    assert p.by_train == pytest.approx({("train.batch", "outside"): US,
                                        **{("train.step", ph): v for ph, v in p.phases.items()
                                           if ph != "outside"}})


def test_the_join_takes_the_forward_threads_op_not_the_recomputes():
    """The recompute's aten::mm carries sequence number 3 on thread 2; a node
    that names (2, 3) is the recompute's graph's, which the backward never
    runs, so a node naming (1, 3) finds no op and no span."""
    ops = [op for op in PROGRAM_OPS if op[0] != BACKWARD_ATTN] + [
        (BACKWARD_ATTN, 82, 140, 2, 3, 1)]
    p = program_pass(PROGRAM_DEVICE, PROGRAM_CPU, ops)
    assert ("model.attention", "backward") not in p.by_model
    assert p.by_model[("", "backward")] == pytest.approx(2 * US)


def test_idle_time_clipped_to_each_span():
    p = _program()
    # busy: 5-15, 25-35, ..., 165-175; the window 0-200
    gaps = [(0, 5)] + [(15 + 20 * i, 25 + 20 * i) for i in range(8)] + [(175, 200)]
    assert sum(e - s for s, e in gaps) * 1e-6 == pytest.approx(p.window_s - p.busy_s)
    assert p.span_idle["step.optimizer"] == pytest.approx((10 + 13) * 1e-6)  # 155-165, 175-188
    assert p.span_idle["train.round"] == pytest.approx((4 + 80 + 24) * 1e-6)
    # 15-25 in the forward's, 84-85 and 95-100 in the recompute's, on thread 2
    assert p.span_idle["model.attention"] == pytest.approx((10 + 1 + 5) * 1e-6)
    # each gap whole to the innermost span open at its start, on any thread
    assert sum(p.idle_in.values()) == pytest.approx(p.window_s - p.busy_s)
    assert p.idle_in[""] == pytest.approx(5e-6)               # before the round
    assert p.idle_in["step.optimizer"] == pytest.approx((10 + 25) * 1e-6)
    assert p.idle_in["model.attention"] == pytest.approx((10 + 10) * 1e-6)  # 15-25, 95-105
    assert p.idle_in["step.backward"] == pytest.approx(3 * 10e-6)  # 75-85, 115-125, 135-145


def test_no_program_spans_no_pass_and_the_window_is_needed():
    plain = [row for row in PROGRAM_CPU if not row[0].startswith(("train.", "step.", "model."))]
    assert program_pass(PROGRAM_DEVICE, plain, PROGRAM_OPS) is None
    with pytest.raises(ValueError):
        program_pass(PROGRAM_DEVICE, PROGRAM_CPU[1:], PROGRAM_OPS)


def test_readings_and_tables_a_step():
    p = _program()
    got = readings(p, steps=2)
    ms = US * 1e3 / 2
    assert got["forward_ms_per_step"] == pytest.approx(3 * ms)
    assert got["recompute_ms_per_step"] == pytest.approx(ms)
    assert got["backward_ms_per_step"] == pytest.approx(3 * ms)
    assert got["optimizer_ms_per_step"] == pytest.approx(ms)
    assert got["head_ms_per_step"] == pytest.approx(2 * ms)
    assert got["optimizer_idle_ms_per_step"] == pytest.approx(23e-3 / 2)
    assert got["layers_forward_ms_per_step"] == pytest.approx(ms)
    assert got["busy_ms_per_step"] == pytest.approx(sum(got[f"{ph}_ms_per_step"]
                                                        for ph in PHASES))
    assert got["outside_activities"] == 1
    lines = tables(p, 2)
    assert lines[0].endswith(" | ".join(PHASES) + " | all")
    assert "  model.attention | 0.005 | 0.005 | 0.005 | 0.000 | 0.000 | 0.015" in lines
    idle = tables(p, 1)
    idle = idle[next(i for i, line in enumerate(idle) if line.startswith("idle ms")):]
    assert "  step.optimizer | 0.023 | 0.035" in idle


def _span(name, start_ms, end_ms):
    return SimpleNamespace(name=name, start_ns=start_ms * 1_000_000, end_ns=end_ms * 1_000_000)


def test_master_ms_per_job():
    """Two rounds of 10 ms, a job each: its batch 1 ms, its step 6 ms."""
    spans = []
    for r in range(2):
        t0 = 10 * r
        spans += [_span("train.round", t0, t0 + 10), _span("train.gate", t0, t0 + 1),
                  _span("train.job", t0 + 1, t0 + 9), _span("train.batch", t0 + 1, t0 + 2),
                  _span("train.step", t0 + 2, t0 + 8)]
    assert master_ms_per_job(spans) == pytest.approx((20 - 2 - 12) / 2)
    assert master_ms_per_job([s for s in spans if s.name != "train.job"]) is None
    assert master_ms_per_job([]) is None


def _block(cpu_extra=()):
    cpu = [(WINDOW, 0, 100, 1, 0),
           ("portbench.step", 10, 90, 1, 1),
           ("portbench.adamw", 70, 85, 1, 2),
           ("cudaLaunchKernel", 12, 13, 1, 101),
           ("ssd.cum", 20, 30, 2, 3),
           ("cudaLaunchKernel", 21, 22, 2, 102),
           ("cudaLaunchKernel", 72, 73, 1, 103),
           ("aten::item", 90, 95, 1, 4), *cpu_extra]
    device = [("gemm_kernel", 14, 40, 101), ("elementwise_kernel", 41, 60, 102),
              ("adam_kernel", 74, 80, 103), ("lost_issuer_kernel", 80, 82, 999),
              ("before_window", -10, -5, 104)]
    return reduce(device, cpu, {"portbench.step", "portbench.adamw", "ssd.cum"})


def test_program_ranges_leave_the_traced_blocks_numbers():
    """The program's spans in a trace leave what the benchmark's metrics read
    of ``trace.reduce`` as it was (ranges, kernels, busy time, the device's
    breakdown, the idle total); only the idle gaps' labels may move to the
    innermost program span."""
    plain = _block()
    spanned = _block([("train.step", 9, 91, 1, 0), ("step.forward", 11, 60, 1, 0),
                      ("model.mlp", 11.5, 59, 1, 0), ("step.optimizer", 69, 89, 1, 0),
                      ("model.ssm", 19, 31, 2, 0), ("train.loss_read", 89.5, 96, 1, 0)])
    for key in ("window_s", "busy_s", "activities", "kernels", "ranges", "unattributed"):
        assert getattr(spanned, key) == getattr(plain, key), key
    assert breakdown(spanned)["device_ops"] == breakdown(plain)["device_ops"]
    assert sum(spanned.gaps.values()) == pytest.approx(sum(plain.gaps.values()))
    # 0-14 the window's, 40-41 and 60-74 the step's, 82-100 the optimizer range's
    assert plain.gaps == pytest.approx({WINDOW: 14e-6, "portbench.step": 15e-6,
                                        "portbench.adamw": 18e-6})
    assert spanned.gaps == pytest.approx({WINDOW: 14e-6, "model.mlp": 1e-6,
                                          "step.forward": 14e-6, "portbench.adamw": 18e-6})


def _event(name, start, end, thread, corr, device_type, seq=-1, fwd_thread=0):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           thread=thread, id=corr, device_type=device_type, sequence_nr=seq,
                           fwd_thread=fwd_thread)


def test_the_pass_on_the_programs_cpu_profile():
    """A coded job of the program (2 layers, full remat) profiled on the CPU,
    each aten op given a launch and an activity of its own, its spans
    recorded too: the master loop's time reads, every phase reads, and the backward's activities are joined through the profiler's
    own sequence numbers to the spans of the layers and the head."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    import repro_torch.configs as tcfgs
    from repro_torch import tracing
    from repro_torch.core import make_scheme
    from repro_torch.train import VectorizedCodedTrainer

    cfg = tcfgs.get_smoke("qwen2-0.5b").replace(num_layers=2)
    tr = VectorizedCodedTrainer(scheme=make_scheme("gc", 8, 1, s=3), cfg=cfg, num_models=2,
                                batch_size=16, seq_len=16, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW), tracing.recording() as spans:
            tr.run(1, np.ones((tr.scheme.T + 2, 8)))
    assert master_ms_per_job(spans) > 0
    events = list(prof.events())
    aten = [e for e in events if e.name.startswith("aten::")]
    for i, e in enumerate(aten):    # a launch and a 1 ns activity for each aten op
        s = e.time_range.start
        events += [_event("cudaLaunchKernel", s, s, e.thread, -1 - i, DeviceType.CPU),
                   _event("k", s, s + 1e-3, 0, -1 - i, DeviceType.CUDA)]
    p = program_pass(*split_events(events))
    assert set(p.phases) == set(PHASES)
    assert sum(p.phases.values()) == pytest.approx(len(aten) * 1e-9)
    n = {key: round(secs / 1e-9) for key, secs in p.by_model.items()}   # activities
    for span in ("model.attention", "model.mlp"):
        assert n[(span, "forward")] and n[(span, "recompute")] and n[(span, "backward")]
    assert n[("model.head", "forward")] and n[("model.head", "backward")]
    assert ("model.head", "recompute") not in n          # the head is not checkpointed
    backward = sum(v for (_, phase), v in n.items() if phase == "backward")
    assert n[("", "backward")] < 0.05 * backward
    assert p.outside == n[("", "outside")] and n[("", "optimizer")] > 0
    assert any(line.startswith("  train.step | ") for line in tables(p, 1))
