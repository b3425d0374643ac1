"""The port's spans: one named interval at each layer boundary of the
program, from the trainer's round down to a model layer's parts.

``span(name, **attrs)`` is a context manager with three behaviours, chosen
when it is entered:

* while ``torch.profiler`` runs, a ``record_function`` range of that name,
  so that the range sits in the profiler's trace on the same clock as the
  device activities its host calls launch;
* inside ``recording()``, also a record in memory (``Span``): name, start
  and end on ``time.perf_counter_ns``, the index of its parent span, the
  job id (the ``job`` attribute of the span itself or of its nearest
  ancestor) and its attributes;
* otherwise a shared null context, behind one check: nothing is
  registered, allocated or synchronised.

Spans nest per thread.  A span opened on a thread with no span open (the
autograd engine's device thread, where a rematerialised layer runs again in
the backward) takes as parent the innermost span open on the thread that
entered ``recording()``: the caller waiting in the backward.

The names in use: ``train.*`` (``train/driver.py``'s round, gate,
schedule, job, batch, step and loss read), ``step.*`` (``train/coded.py``'s
forward, backward and optimizer), ``model.*`` (``models/transformer.py``'s
attention, mlp, ssm and head), ``ssd.*`` (``models/ssm.py``'s passes of the
chunked scan) and ``moe`` (``models/layers.py``'s mixture of experts).
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field

import torch

_NULL = contextlib.nullcontext()


@dataclass
class Span:
    """One recorded span; ``end_ns`` is 0 while it is open, ``parent`` -1 at
    the top."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    job: int | None
    thread: int
    attrs: dict = field(default_factory=dict)


class _Recorder:
    def __init__(self):
        self.spans: list[Span] = []
        self.owner = threading.get_ident()
        self.stacks: dict[int, list[int]] = {}
        self.lock = threading.Lock()

    def open(self, name: str, attrs: dict) -> int:
        thread = threading.get_ident()
        with self.lock:
            stack = self.stacks.setdefault(thread, [])
            outer = stack or self.stacks.get(self.owner) or ()
            parent = outer[-1] if outer else -1
            job = attrs.get("job", self.spans[parent].job if parent >= 0 else None)
            self.spans.append(Span(name, time.perf_counter_ns(), 0, parent, job, thread, attrs))
            index = len(self.spans) - 1
            stack.append(index)
        return index

    def close(self, index: int) -> None:
        self.spans[index].end_ns = time.perf_counter_ns()
        with self.lock:
            self.stacks[threading.get_ident()].remove(index)


#: the recorder of the innermost ``recording()`` open, or None
_active: _Recorder | None = None


class _Recorded:
    """A span entered while recording: a record, and a profiler range where
    the profiler runs."""

    __slots__ = ("recorder", "name", "attrs", "index", "range")

    def __init__(self, recorder: _Recorder, name: str, attrs: dict):
        self.recorder, self.name, self.attrs = recorder, name, attrs
        self.range = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.index = self.recorder.open(self.name, self.attrs)
        return self

    def __exit__(self, *exc):
        self.recorder.close(self.index)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """The span ``name`` (module docstring); ``attrs`` are kept with its
    record (``job=`` sets the job id it and its descendants carry)."""
    recorder = _active
    if recorder is not None:
        return _Recorded(recorder, name, attrs)
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


@contextlib.contextmanager
def recording():
    """Record every span entered, on any thread, until the block ends; yields
    the list the records are appended to, in the order they were opened."""
    global _active
    outer, _active = _active, _Recorder()
    try:
        yield _active.spans
    finally:
        _active = outer
