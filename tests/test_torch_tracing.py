"""The port's spans (``repro_torch/tracing.py``): off, they keep nothing and
open no profiler range; recording, they nest with their parents and job ids,
across threads too; and a CPU run of ``VectorizedCodedTrainer`` records each
decoded job's batch, step (forward, backward, optimizer) and loss read, with
every rematerialised layer's span opened again inside the backward."""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.configs as tcfgs
from repro_torch import tracing
from repro_torch.core import make_scheme
from repro_torch.tracing import recording, span
from repro_torch.train import VectorizedCodedTrainer

N, BATCH = 8, 16


def _range_names(prof) -> set:
    return {e.name for e in prof.events()}


def test_span_off_keeps_no_record_and_opens_no_range():
    assert span("train.job", job=1) is span("model.head") is tracing._NULL
    with span("train.job", job=1):
        pass
    with recording() as spans:
        pass
    assert spans == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(2).sum()
    with profile(activities=[ProfilerActivity.CPU]) as prof_on:
        with span("model.head"):
            torch.ones(2).sum()
    assert "model.head" not in _range_names(prof) and "model.head" in _range_names(prof_on)


def test_recorded_spans_nest_with_parents_and_job_ids():
    with recording() as spans:
        with span("train.round", t=1):
            with span("train.job", job=3):
                with span("train.step"):
                    with span("step.forward"):
                        pass
            with span("train.job", job=4):
                with pytest.raises(KeyError):
                    with span("train.batch"):
                        raise KeyError("a span left by an exception still closes")
    assert span("x") is tracing._NULL          # recording ended
    names = [s.name for s in spans]
    assert names == ["train.round", "train.job", "train.step", "step.forward", "train.job",
                     "train.batch"]
    assert [s.parent for s in spans] == [-1, 0, 1, 2, 0, 4]
    assert [s.job for s in spans] == [None, 3, 3, 3, 4, 4]
    assert spans[0].attrs == {"t": 1} and spans[1].attrs == {"job": 3}
    for s in spans:
        assert 0 < s.start_ns <= s.end_ns
        if s.parent >= 0:
            outer = spans[s.parent]
            assert outer.start_ns <= s.start_ns and s.end_ns <= outer.end_ns


def test_a_span_on_another_thread_takes_the_waiting_callers_span():
    """The autograd engine's device thread opens a rematerialised layer's span
    with none open on its own thread: its parent is the span the caller waits
    in, and it carries that span's job."""
    with recording() as spans:
        with span("train.job", job=7):
            with span("step.backward"):
                worker = threading.Thread(target=lambda: span("model.mlp").__enter__()
                                          .__exit__(None, None, None))
                worker.start()
                worker.join(timeout=30)
                assert not worker.is_alive()
    assert [s.name for s in spans] == ["train.job", "step.backward", "model.mlp"]
    assert spans[2].parent == 1 and spans[2].job == 7
    assert spans[2].thread != spans[1].thread


def test_recording_with_the_profiler_records_and_ranges():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recording() as spans:
            with span("step.optimizer"):
                torch.ones(2).sum()
    assert [s.name for s in spans] == ["step.optimizer"]
    assert "step.optimizer" in _range_names(prof)


def _children(spans, index):
    return [s for s in spans if s.parent == index]


def _below(spans, index) -> list:
    """The spans under spans[index], at any depth."""
    out, frontier = [], [index]
    while frontier:
        kids = [i for i, s in enumerate(spans) if s.parent in frontier]
        out += [spans[i] for i in kids]
        frontier = kids
    return out


def _trained(arch: str, remat: str, jobs: int = 3):
    cfg = tcfgs.get_smoke(arch).replace(num_layers=2, remat_policy=remat)
    tr = VectorizedCodedTrainer(scheme=make_scheme("gc", N, jobs, s=3), cfg=cfg, num_models=2,
                                batch_size=BATCH, seq_len=16, lr=1e-3, seed=0, device="cpu")
    delays = np.ones((jobs + tr.scheme.T + 1, N))
    delays[0, 5] = 40.0                    # a straggler the gate waits out or drops
    with recording() as spans:
        tr.run(jobs, delays)
    return tr, spans, cfg


@pytest.fixture(scope="module")
def dense_run():
    return _trained("qwen2-0.5b", "full")


def test_trainer_records_each_decoded_jobs_spans(dense_run):
    tr, spans, _ = dense_run
    jobs = [(i, s) for i, s in enumerate(spans) if s.name == "train.job"]
    assert sorted(s.job for _, s in jobs) == sorted(tr.job_done_time) == [1, 2, 3]
    for i, job in jobs:
        assert spans[job.parent].name == "train.round"
        assert [c.name for c in _children(spans, i)] == ["train.batch", "train.step",
                                                         "train.loss_read"]
        step = next(k for k, s in enumerate(spans) if s.parent == i and s.name == "train.step")
        assert [c.name for c in _children(spans, step)] == ["step.forward", "step.backward",
                                                            "step.optimizer"]
        assert {s.job for s in _below(spans, i)} == {job.job}
    rounds = [(i, s) for i, s in enumerate(spans) if s.name == "train.round"]
    assert [s.attrs["t"] for _, s in rounds] == list(range(1, len(rounds) + 1))
    for i, _ in rounds:
        assert [c.name for c in _children(spans, i)][:2] == ["train.gate", "train.schedule"]
    assert all(s.end_ns >= s.start_ns > 0 for s in spans)


@pytest.mark.parametrize("arch,remat,layer_spans", [
    ("qwen2-0.5b", "full", ("model.attention", "model.mlp")),
    ("qwen2-0.5b", "none", ("model.attention", "model.mlp")),
    ("mamba2-1.3b", "full", ("model.ssm",)),
])
def test_remat_opens_each_layers_span_again_inside_the_backward(arch, remat, layer_spans,
                                                               dense_run):
    tr, spans, cfg = dense_run if (arch, remat) == ("qwen2-0.5b", "full") else \
        _trained(arch, remat, jobs=1)
    layers = cfg.num_layers
    for i, s in enumerate(spans):
        if s.name not in ("step.forward", "step.backward"):
            continue
        below = [b.name for b in _below(spans, i)]
        again = s.name == "step.forward" or remat == "full"
        for name in layer_spans:
            assert below.count(name) == (layers if again else 0), (s.name, name, below)
        assert ("model.head" in below) == (s.name == "step.forward")
