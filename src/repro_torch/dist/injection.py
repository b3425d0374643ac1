"""Worker-side fault injection for the distributed harness.

Port of ``src/repro/dist/injection.py``.

The master *enacts* a straggler trace instead of merely simulating it:
each round message carries the worker's planned delay (seconds, already
scaled to wall clock), and the worker burns that time before reporting —
either asleep (``sleep``, cheap on CI) or spinning (``spin``, the
``loop()`` idiom from the MPI coded-matmul harnesses, closer to a worker
that is genuinely busy).  Static knobs live in :class:`FaultSpec`:

* ``drop_rounds`` — first-attempt result messages for these rounds are
  computed but never sent (lost on the wire); the master's timeout /
  resend path recovers them on the retry attempt.
* ``kill_after`` — the worker process exits cleanly right after
  reporting this round, modelling a permanently lost worker; the master
  degrades it to an always-straggler row — or, with a respawn budget
  (``repro_torch.dist.supervisor``), brings a replacement back up.
* ``ready_delay`` — seconds slept before the readiness handshake,
  modelling a slow (re)join: the supervisor keeps the worker in the
  ``respawning`` state until the delayed ``ready`` lands.

Network faults (:class:`NetFaultSpec`) are enacted by the TCP backend
(``repro_torch.dist.net.TcpWorkerLink``) *on the master side of the wire*,
where the harness can hold, delay, drop, duplicate, and reorder frames
deterministically per worker: one-way / two-way partitions for a round
window (or until a wall-clock heal), added latency with jitter, and
probabilistic drop / duplicate / reorder.  The pipe backend ignores
them (a same-process pipe has no wire to be unreliable on).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass(frozen=True)
class FaultSpec:
    """Static fault knobs for one worker (per-round delays arrive in the
    round messages, derived from the enacted trace)."""

    delay_mode: str = "sleep"            # "sleep" | "spin"
    drop_rounds: frozenset = field(default_factory=frozenset)
    kill_after: int | None = None        # exit after reporting round k
    ready_delay: float = 0.0             # sleep before the ready handshake

    def drops(self, t: int, attempt: int) -> bool:
        return attempt == 0 and t in self.drop_rounds

    def dies_after(self, t: int) -> bool:
        return self.kill_after is not None and t >= self.kill_after


@dataclass(frozen=True)
class NetFaultSpec:
    """Network fault knobs for one worker's TCP link (master side).

    Partition semantics: from ``partition_round`` on, worker->master
    frames are *held* (a backed-up TCP queue, flushed in order on heal)
    and — in ``"twoway"`` mode — master->worker sends are swallowed.
    The partition heals after ``partition_rounds`` master rounds, or —
    when ``heal_after_s`` is set — after that much wall clock from the
    partition's onset (needed when the master *blocks* inside a round
    waiting the partition out: the round counter cannot advance, the
    clock always does).

    The probabilistic knobs apply per frame, driven by a generator
    seeded on ``(seed, worker)``: ``drop_p`` loses the frame (both
    directions), ``dup_p`` delivers it twice (exercising the mid-filter
    dedup), ``latency_s`` + ``latency_jitter_s`` defer delivery, and
    ``reorder_p`` holds a frame back ``reorder_hold_s`` so later frames
    overtake it."""

    partition_round: int | None = None   # first partitioned round
    partition_rounds: int = 1            # duration in master rounds
    heal_after_s: float | None = None    # wall-clock heal override
    partition_mode: str = "twoway"       # "oneway" | "twoway"
    latency_s: float = 0.0
    latency_jitter_s: float = 0.0
    drop_p: float = 0.0
    dup_p: float = 0.0
    reorder_p: float = 0.0
    reorder_hold_s: float = 0.02
    seed: int = 0


def enact_delay(seconds: float, mode: str = "sleep") -> None:
    """Burn ``seconds`` of wall clock: ``sleep`` yields the CPU, ``spin``
    busy-waits on the monotonic clock (the MPI harnesses' ``loop()``)."""
    if seconds <= 0.0:
        return
    if mode == "spin":
        deadline = time.perf_counter() + seconds
        x = 1.0000001
        while time.perf_counter() < deadline:
            x = x * 1.0000001 % 7.0  # keep the ALU honest
    else:
        time.sleep(seconds)
