"""The traced block: one block of jobs under ``torch.profiler`` (host and
device), reduced to device time by kernel, by category and by the profiler
range a launch was issued in, the device's busy time in the window, and the
idle gaps by what the host was doing.

The profiler can lose device activities at the ends of a session, so the
block runs between spin kernels (``torch.cuda._sleep``) that absorb the loss
and are left out.  A device activity is attributed to the innermost range,
on the thread that issued it, around the runtime call that launched it (the
two share CUPTI's correlation id).
"""

from __future__ import annotations

import heapq
import re
import time
from collections import defaultdict
from dataclasses import dataclass, field

SPINS = 16
WINDOW = "portbench.window"


@dataclass
class Trace:
    """A traced block, reduced.  Times in seconds."""

    window_s: float
    busy_s: float
    activities: int
    kernels: dict = field(default_factory=dict)     # name -> [launches, seconds]
    ranges: dict = field(default_factory=dict)      # range name -> device seconds
    gaps: dict = field(default_factory=dict)        # host activity -> idle seconds
    unattributed: int = 0                           # device activities of no runtime call

    def kernel_time(self, pattern: str) -> tuple[int, float]:
        """(launches, seconds) of the kernels whose name holds ``pattern``."""
        n = t = 0
        for name, (count, secs) in self.kernels.items():
            if pattern in name:
                n, t = n + count, t + secs
        return n, t

    def mean_time(self, patterns: dict) -> dict[str, float]:
        """Seconds a launch of each kernel family ({label: name pattern}),
        averaged over the launches the profiler recorded."""
        out = {}
        for label, pattern in patterns.items():
            n, t = self.kernel_time(pattern)
            if n:
                out[label] = t / n
        return out


def category(name: str) -> str:
    """A device activity's category for the breakdown."""
    for key, label in (("attn_bwd", "attention backward kernels"),
                       ("attn_fwd", "attention forward kernel"),
                       ("rmsnorm_bwd", "rmsnorm backward kernel"),
                       ("rmsnorm_kernel", "rmsnorm kernel"),
                       ("ssd_bwd_", "ssd chunk scan backward kernels"),
                       ("ssd_bf16_kernel", "ssd chunk scan kernel"),
                       ("ssd_f32_kernel", "ssd chunk scan kernel"),
                       ("coded_combine_kernel", "coded_combine kernel")):
        if key in name:
            return label
    low = name.lower()
    if any(w in low for w in ("gemm", "gemv", "xmma", "cutlass", "nvjet", "splitk")):
        return "matmul (cuBLAS)"
    if low.startswith("memcpy") or low.startswith("memset"):
        return name.split(" (")[0]
    head = name.replace("(anonymous namespace)::", "").split("(")[0]
    functors = re.findall(r"(\w*Functor\w*)<([\w:]+)", head)   # the op is the innermost
    if functors:
        return "torch {}<{}>".format(*functors[-1])
    m = re.search(r"\w+_kernel\w*|\w+Kernel\w*", head) or re.search(r"\w+(?=<)", head)
    return "torch " + (m.group(0) if m else name[:60])


def union_length(intervals) -> tuple[float, list]:
    """(length of the union, the gaps between its pieces) of (start, end)
    intervals."""
    total, gaps, cur = 0.0, [], None
    for s, e in sorted(intervals):
        if cur is None:
            cur = [s, e]
        elif s > cur[1]:
            total += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        total += cur[1] - cur[0]
    return total, gaps


def innermost(events, times):
    """For each time of ``times`` (sorted), the name of the latest-started
    event of ``events`` ((name, start, end), any order) that holds it, or
    None."""
    events = sorted(events, key=lambda e: e[1])
    heap, out, i = [], [], 0
    for t in times:
        while i < len(events) and events[i][1] <= t:
            heapq.heappush(heap, (-events[i][1], events[i][2], events[i][0]))
            i += 1
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def reduce(device, cpu, ranges: set) -> Trace:
    """Reduce one traced block.

    ``device``: (name, start_us, end_us, correlation) of every device
    activity; ``cpu``: (name, start_us, end_us, thread, correlation) of every
    host event, the block's ``WINDOW`` range among them.  Device time is
    attributed to the innermost range of ``ranges`` (names) around the
    runtime call (a host event named ``cu*``) that launched it, on that call's
    thread."""
    win = [(s, e) for name, s, e, _, _ in cpu if name == WINDOW]
    if not win:
        raise ValueError("the trace holds no window range")
    w0, w1 = win[0]
    work = [(n, max(s, w0), min(e, w1), c) for n, s, e, c in device if e > w0 and s < w1]
    busy_us, gaps = union_length((s, e) for _, s, e, _ in work)
    if work:  # the idle time before the first activity and after the last counts
        first, last = min(s for _, s, _, _ in work), max(e for _, _, e, _ in work)
        gaps = [(w0, first)] + gaps + [(last, w1)]
    kernels: dict = defaultdict(lambda: [0, 0.0])
    for n, s, e, _ in work:
        kernels[n][0] += 1
        kernels[n][1] += (e - s) / 1e6
    # the range around each runtime call, thread by thread
    by_thread = defaultdict(list)
    for name, s, e, thread, corr in cpu:
        if name in ranges:
            by_thread[thread].append((name, s, e))
    issued_in = {}
    calls = defaultdict(list)
    for name, s, _, thread, corr in cpu:
        if name.startswith("cu"):
            calls[thread].append((s, corr))
    for thread, items in calls.items():
        items.sort()
        names = innermost(by_thread.get(thread, []), [s for s, _ in items])
        issued_in.update((corr, rng) for (_, corr), rng in zip(items, names) if rng)
    launched = {corr for items in calls.values() for _, corr in items}
    range_time: dict = defaultdict(float)
    unattributed = 0
    for _, s, e, corr in work:
        if corr not in launched:
            unattributed += 1
        rng = issued_in.get(corr)
        if rng:
            range_time[rng] += (e - s) / 1e6
    # what the host was doing when the device went idle: the innermost host
    # event (runtime calls aside) at the gap's start
    gaps = [(s, e) for s, e in gaps if e > s]
    host = [(name, s, e) for name, s, e, _, _ in cpu if not name.startswith("cu")]
    labels = innermost(host, [s for s, _ in sorted(gaps)])
    idle: dict = defaultdict(float)
    for (s, e), label in zip(sorted(gaps), labels):
        idle[label or "outside any host event"] += (e - s) / 1e6
    return Trace(window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6, activities=len(work),
                 kernels=dict(kernels), ranges=dict(range_time), gaps=dict(idle),
                 unattributed=unattributed)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The contract's ``breakdown``: the device's time by category and the
    idle gaps by host activity, the largest ``top`` of each, in seconds."""
    cats: dict = defaultdict(float)
    for name, (_, secs) in trace.kernels.items():
        cats[category(name)] += secs
    return {
        "device_ops": sorted(([k, v] for k, v in cats.items()), key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(([k, v] for k, v in trace.gaps.items()),
                            key=lambda kv: -kv[1])[:top],
    }


def profile_block(fn, ranges: set) -> Trace:
    """Run ``fn()`` once under the profiler, host and device, and reduce it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for lead in range(2 * SPINS):
            torch.cuda._sleep(1000)
            if lead == SPINS - 1:
                time.sleep(0.05)
        torch.cuda.synchronize()
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
        for _ in range(SPINS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    events = prof.events()
    cpu, device = [], []
    for e in events:
        if e.device_type == DeviceType.CPU:
            cpu.append((e.name, e.time_range.start, e.time_range.end, e.thread, e.id))
    annotations = {name for name, *_ in cpu if not name.startswith(("aten::", "cu"))}
    for e in events:
        if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name \
                and e.name not in annotations:
            device.append((e.name, e.time_range.start, e.time_range.end, e.id))
    return reduce(device, cpu, ranges)
