"""Observability for the distributed harness: per-worker per-round
timestamps assembled into a runtime ledger and a replayable
``TraceModel`` recording.

Port of ``src/repro/dist/telemetry.py``.

Every round the master logs, per worker: when work was sent, when the
worker received it, how long real compute took, how much delay was
enacted, and when the result arrived back — all on the shared
``perf_counter`` clock (one machine, one monotonic base).  The ledger
aggregates these into

* ``effective_pattern()`` — the gate-admitted straggler rows, which by
  construction replay bit-identically through ``simulate_fast`` on the
  enacted delay profile;
* ``measured_times()`` — measured round-trip seconds per (round,
  worker), NaN where no result ever arrived (dead / discarded);
* ``to_trace_model()`` — a ``TraceModel`` recording (pattern +
  measured timings) ready for ``TraceModel.to_json`` and the
  ``recorded-harness`` scenario in ``trace_library``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class WorkerRoundStat:
    """One worker's life cycle inside one round (master clock unless
    noted; ``None`` where the event never happened)."""

    sent: float | None = None           # master: work dispatched
    reported: float | None = None       # master: result arrived
    recv: float | None = None           # worker: work received
    compute_s: float | None = None      # worker: real chunk-grad time
    delay_s: float | None = None        # worker: enacted injected delay
    wire_send_s: float | None = None    # master->worker wire seconds
    wire_recv_s: float | None = None    # worker->master wire seconds
    attempts: int = 0


@dataclass
class RoundRecord:
    t: int
    start: float                        # master clock at round start
    duration_s: float = 0.0             # measured wall-clock duration
    analytic_s: float = 0.0             # planned-model duration (scaled)
    planned_row: np.ndarray | None = None    # mu-rule candidates (plan)
    effective_row: np.ndarray | None = None  # gate-admitted stragglers
    waited: list[int] = field(default_factory=list)
    deaths: list[int] = field(default_factory=list)
    retries: int = 0
    stats: list[WorkerRoundStat] = field(default_factory=list)


@dataclass
class RunLedger:
    """Telemetry for one harness run.

    ``events`` is the supervision log — ``{"round", "worker", "kind"}``
    dicts with kinds ``death`` / ``respawn`` / ``rejoin`` / ``lost`` /
    ``degrade`` — shared by reference with the :class:`Supervisor` so
    every fleet transition lands here and rides into the ``TraceModel``
    v2 recording.
    """

    n: int
    time_scale: float
    records: list[RoundRecord] = field(default_factory=list)
    events: list = field(default_factory=list)

    def new_round(self, t: int, start: float) -> RoundRecord:
        rec = RoundRecord(
            t=t, start=start,
            stats=[WorkerRoundStat() for _ in range(self.n)],
        )
        self.records.append(rec)
        return rec

    # -- aggregates ------------------------------------------------------
    @property
    def rounds(self) -> int:
        return len(self.records)

    def effective_pattern(self) -> np.ndarray:
        rows = [r.effective_row for r in self.records
                if r.effective_row is not None]
        if not rows:
            return np.zeros((0, self.n), dtype=bool)
        return np.stack(rows)

    def measured_times(self) -> np.ndarray:
        """(rounds, n) measured send->report seconds; NaN when absent."""
        out = np.full((self.rounds, self.n), np.nan)
        for k, rec in enumerate(self.records):
            for i, st in enumerate(rec.stats):
                if st.sent is not None and st.reported is not None:
                    out[k, i] = st.reported - st.sent
        return out

    def measured_makespan(self) -> float:
        return float(sum(r.duration_s for r in self.records))

    def analytic_makespan(self) -> float:
        return float(sum(r.analytic_s for r in self.records))

    def total_retries(self) -> int:
        return int(sum(r.retries for r in self.records))

    def waitouts(self) -> int:
        return int(sum(bool(r.waited) for r in self.records))

    def overhead_s(self) -> float:
        """Mean per-round overhead: measured minus analytic duration."""
        if not self.records:
            return 0.0
        return float(np.mean(
            [r.duration_s - r.analytic_s for r in self.records]
        ))

    def worker_counters(self) -> dict:
        """Per-worker flakiness counters for JSON reports:
        resends (retry attempts beyond the first send), deaths,
        respawns, rejoins, partitions, heals (each a length-``n``
        list), plus the compute-vs-communication split: ``wire_send_s``
        / ``wire_recv_s`` are each worker's summed master->worker /
        worker->master wire seconds over the run."""
        resends = [0] * self.n
        wire_send = [0.0] * self.n
        wire_recv = [0.0] * self.n
        for rec in self.records:
            for i, st in enumerate(rec.stats):
                resends[i] += max(0, st.attempts - 1)
                if st.wire_send_s is not None:
                    wire_send[i] += st.wire_send_s
                if st.wire_recv_s is not None:
                    wire_recv[i] += st.wire_recv_s
        by_kind = {"death": [0] * self.n, "respawn": [0] * self.n,
                   "rejoin": [0] * self.n, "partition": [0] * self.n,
                   "heal": [0] * self.n}
        for ev in self.events:
            k, w = ev.get("kind"), ev.get("worker")
            if k in by_kind and w is not None and 0 <= w < self.n:
                by_kind[k][w] += 1
        return {
            "resends": resends,
            "deaths": by_kind["death"],
            "respawns": by_kind["respawn"],
            "rejoins": by_kind["rejoin"],
            "partitions": by_kind["partition"],
            "heals": by_kind["heal"],
            "wire_send_s": wire_send,
            "wire_recv_s": wire_recv,
        }

    def to_trace_model(self, *, base_time: float = 1.0,
                       slow_factor: float = 4.0, jitter: float = 0.05,
                       compute_scale: float = 8.0, seed: int = 0):
        """The run as a replayable recording: the gate-admitted pattern
        plus the measured per-(round, worker) wall-clock timings; an
        elastic run (any supervision events) additionally carries the
        event log and serializes as schema v2."""
        from repro_torch.core.straggler import TraceModel

        return TraceModel(
            pattern=self.effective_pattern(),
            base_time=base_time,
            slow_factor=slow_factor,
            jitter=jitter,
            compute_scale=compute_scale,
            seed=seed,
            timings=self.measured_times(),
            events=[dict(ev) for ev in self.events] or None,
        )

    def summary(self) -> dict:
        meas, ana = self.measured_makespan(), self.analytic_makespan()
        wc = self.worker_counters()
        return {
            "rounds": self.rounds,
            "measured_makespan_s": meas,
            "analytic_makespan_s": ana,
            "agreement": meas / ana if ana > 0 else float("nan"),
            "waitouts": self.waitouts(),
            "retries": self.total_retries(),
            "deaths": sorted({w for r in self.records for w in r.deaths}),
            "respawns": int(sum(wc["respawns"])),
            "rejoins": int(sum(wc["rejoins"])),
            "partitions": int(sum(wc["partitions"])),
            "heals": int(sum(wc["heals"])),
            "wire_send_s": float(sum(wc["wire_send_s"])),
            "wire_recv_s": float(sum(wc["wire_recv_s"])),
            "mean_round_overhead_s": self.overhead_s(),
        }

    # -- checkpoint round-trip (repro_torch.checkpoint.io blob leaves) ---------
    def to_state(self) -> dict:
        """The ledger as a ``save_blob``-able structure (arrays +
        JSON-able skeleton), exact enough that a resumed master keeps
        appending to the same telemetry stream."""
        R, n = self.rounds, self.n

        def stamp(get):
            out = np.full((R, n), np.nan)
            for k, rec in enumerate(self.records):
                for i, st in enumerate(rec.stats):
                    v = get(st)
                    if v is not None:
                        out[k, i] = v
            return out

        def rowstack(get):
            has = np.array([get(r) is not None for r in self.records])
            rows = np.zeros((R, n), dtype=bool)
            for k, rec in enumerate(self.records):
                if has[k]:
                    rows[k] = get(rec)
            return has, rows

        has_p, planned = rowstack(lambda r: r.planned_row)
        has_e, effective = rowstack(lambda r: r.effective_row)
        return {
            "n": n,
            "time_scale": float(self.time_scale),
            "t": np.array([r.t for r in self.records], dtype=np.int64),
            "start": np.array([r.start for r in self.records]),
            "duration_s": np.array([r.duration_s for r in self.records]),
            "analytic_s": np.array([r.analytic_s for r in self.records]),
            "has_planned": has_p, "planned": planned,
            "has_effective": has_e, "effective": effective,
            "waited": [list(map(int, r.waited)) for r in self.records],
            "deaths": [list(map(int, r.deaths)) for r in self.records],
            "round_retries": np.array([r.retries for r in self.records],
                                      dtype=np.int64),
            "sent": stamp(lambda s: s.sent),
            "reported": stamp(lambda s: s.reported),
            "recv": stamp(lambda s: s.recv),
            "compute_s": stamp(lambda s: s.compute_s),
            "delay_s": stamp(lambda s: s.delay_s),
            "wire_send_s": stamp(lambda s: s.wire_send_s),
            "wire_recv_s": stamp(lambda s: s.wire_recv_s),
            "attempts": np.array(
                [[st.attempts for st in r.stats] for r in self.records],
                dtype=np.int64,
            ).reshape(R, n),
            "events": [dict(ev) for ev in self.events],
        }

    @classmethod
    def from_state(cls, state: dict) -> "RunLedger":
        n = int(state["n"])
        led = cls(n=n, time_scale=float(state["time_scale"]),
                  events=[dict(ev) for ev in state["events"]])
        R = len(state["t"])

        def opt(a):
            return None if np.isnan(a) else float(a)

        def grid(key):
            # wire stamps postdate the v1 checkpoint layout: absent ->
            # all-NaN, so pre-wire checkpoints still restore
            a = state.get(key)
            if a is None:
                return np.full((R, n), np.nan)
            return np.asarray(a)

        wire_send = grid("wire_send_s")
        wire_recv = grid("wire_recv_s")
        for k in range(R):
            rec = led.new_round(int(state["t"][k]),
                                float(state["start"][k]))
            rec.duration_s = float(state["duration_s"][k])
            rec.analytic_s = float(state["analytic_s"][k])
            if state["has_planned"][k]:
                rec.planned_row = np.asarray(state["planned"][k],
                                             dtype=bool)
            if state["has_effective"][k]:
                rec.effective_row = np.asarray(state["effective"][k],
                                               dtype=bool)
            rec.waited = list(map(int, state["waited"][k]))
            rec.deaths = list(map(int, state["deaths"][k]))
            rec.retries = int(state["round_retries"][k])
            for i, st in enumerate(rec.stats):
                st.sent = opt(state["sent"][k][i])
                st.reported = opt(state["reported"][k][i])
                st.recv = opt(state["recv"][k][i])
                st.compute_s = opt(state["compute_s"][k][i])
                st.delay_s = opt(state["delay_s"][k][i])
                st.wire_send_s = opt(wire_send[k][i])
                st.wire_recv_s = opt(wire_recv[k][i])
                st.attempts = int(state["attempts"][k][i])
        return led
