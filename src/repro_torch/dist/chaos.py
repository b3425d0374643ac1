"""Chaos-campaign driver: composed fault scenarios with end-to-end
invariant checks.

Port of ``src/repro/dist/chaos.py``.

A :class:`ChaosCampaign` composes per-worker :class:`FaultSpec`\\ s into
a timed scenario over the elastic harness — kill waves, correlated
regional outages, flapping workers, delayed rejoins — and
:func:`run_campaign` executes it and *audits* the result instead of
just returning it:

* every one of the J jobs decoded exactly (certificate vs the
  full-batch gradient);
* the run terminated without deadlock or un-budgeted abort;
* the telemetry stream is complete — one ledger record per attempted
  round, measured round times aligned, every committed round carrying
  its gate-admitted row, timestamps ordered;
* the supervision log shows the transitions the scenario was built to
  provoke (minimum respawn / rejoin / degrade counts).

Violations come back as human-readable strings on the
:class:`CampaignReport` rather than raising, so a campaign sweep can
report every broken invariant at once (``tests/test_torch_dist_elastic.py``
asserts ``report.passed``).

Builders (``kill_wave``, ``regional_outage``, ``flapping``,
``delayed_rejoin``) cover the canonical process-fault scenarios;
``partition_heal`` and ``lossy_network`` run on the TCP transport and
exercise the network-fault tier (``repro_torch.dist.net``): partitions must
be told apart from deaths (healing with NO respawn burned) and a lossy
wire must never corrupt a decode.  Campaigns are plain dataclasses, so
bespoke ones are one literal away.  See ``docs/fault_tolerance.md``
for how each scenario exercises the supervision state machine.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .injection import FaultSpec, NetFaultSpec
from .master import HarnessConfig, HarnessResult, run_harness


@dataclass
class ChaosCampaign:
    """One composed fault scenario plus the invariants it must provoke."""

    name: str
    n: int
    jobs: int
    scheme: str = "gc"
    params: dict = field(default_factory=lambda: {"s": 1})
    faults: dict = field(default_factory=dict)          # wid -> FaultSpec
    respawn_faults: dict = field(default_factory=dict)  # respawned incarnation
    respawn_max_attempts: int = 3
    respawn_backoff_s: float = 0.2
    respawn_backoff_max_s: float = 1.0
    degrade: str = "off"
    expect_abort: bool = False
    transport: str = "pipe"                             # "pipe" | "tcp"
    net_faults: dict = field(default_factory=dict)      # wid -> NetFaultSpec
    min_respawns: int = 0
    min_rejoins: int = 0
    min_degrades: int = 0
    min_partitions: int = 0
    min_heals: int = 0
    max_respawns: int | None = None     # spurious-respawn ceiling
    note: str = ""
    config_kw: dict = field(default_factory=dict)       # extra HarnessConfig


@dataclass
class CampaignReport:
    campaign: str
    result: HarnessResult
    violations: list = field(default_factory=list)

    @property
    def passed(self) -> bool:
        return not self.violations

    def summary(self) -> dict:
        res = self.result
        return {
            "campaign": self.campaign,
            "passed": self.passed,
            "violations": list(self.violations),
            "rounds": res.ledger.rounds,
            "decoded": len(res.decoded_jobs),
            "jobs": res.J,
            "decode_max_err": res.decode_max_err,
            "deaths": res.deaths,
            "respawns": res.respawns,
            "rejoins": res.rejoins,
            "partitions": res.partitions,
            "heals": res.heals,
            "degraded": res.degraded,
            "aborted": res.aborted,
        }


# ---------------------------------------------------------------------------
# canonical scenario builders
# ---------------------------------------------------------------------------


def _bursty_defaults(n: int, kw: dict) -> dict:
    """Builders default to M-SGC's bursty design model (B=1): it admits
    a dead worker's row for exactly one round before the gate must wait
    it out, so the master deterministically BLOCKS on the rejoin — the
    supervision path these scenarios exist to provoke.  (Under GC-Rep
    a dead lane can stay admissible forever and a fast run may finish
    before any replacement reports ready.)"""
    kw.setdefault("scheme", "m-sgc")
    kw.setdefault("params", {"B": 1, "W": 3, "lam": n})
    return kw


def kill_wave(n: int, jobs: int, kills: dict, **kw) -> ChaosCampaign:
    """Workers die at different rounds (``kills``: wid -> round) and the
    respawn budget brings each one back clean."""
    kw = _bursty_defaults(n, kw)
    kw.setdefault("min_respawns", len(kills))
    kw.setdefault("min_rejoins", len(kills))
    return ChaosCampaign(
        name=kw.pop("name", "kill-wave"),
        n=n, jobs=jobs,
        faults={w: FaultSpec(kill_after=r) for w, r in kills.items()},
        note=f"kill {sorted(kills)} at rounds "
             f"{[kills[w] for w in sorted(kills)]}, respawn clean",
        **kw,
    )


def regional_outage(n: int, jobs: int, region, at_round: int,
                    **kw) -> ChaosCampaign:
    """A correlated outage: every worker in ``region`` dies in the same
    round (one failure domain), all respawn."""
    region = sorted(region)
    kw = _bursty_defaults(n, kw)
    kw.setdefault("min_respawns", len(region))
    kw.setdefault("min_rejoins", len(region))
    return ChaosCampaign(
        name=kw.pop("name", "regional-outage"),
        n=n, jobs=jobs,
        faults={w: FaultSpec(kill_after=at_round) for w in region},
        note=f"region {region} out at round {at_round}",
        **kw,
    )


def flapping(n: int, jobs: int, worker: int, first_kill: int,
             rekill_after: int, **kw) -> ChaosCampaign:
    """One worker dies, rejoins, and dies again — and again: EVERY
    respawned incarnation carries the same ``kill_after``, so from
    ``rekill_after`` on the worker serves exactly one round per respawn.
    The default budget is sized so the run can flap its way to the end
    (one attempt per remaining round) rather than exhausting mid-run."""
    kw = _bursty_defaults(n, kw)
    kw.setdefault("respawn_max_attempts", jobs + 8)
    kw.setdefault("min_respawns", 2)
    kw.setdefault("min_rejoins", 1)
    return ChaosCampaign(
        name=kw.pop("name", "flapping"),
        n=n, jobs=jobs,
        faults={worker: FaultSpec(kill_after=first_kill)},
        respawn_faults={worker: FaultSpec(kill_after=rekill_after)},
        note=f"worker {worker} flaps: dies at {first_kill}, "
             f"again at {rekill_after}",
        **kw,
    )


def delayed_rejoin(n: int, jobs: int, worker: int, at_round: int,
                   ready_delay: float, **kw) -> ChaosCampaign:
    """The replacement process is slow to report ready
    (``FaultSpec.ready_delay``), so the fleet runs short-handed for a
    while before the rejoin replay catches the worker up."""
    kw = _bursty_defaults(n, kw)
    kw.setdefault("min_respawns", 1)
    kw.setdefault("min_rejoins", 1)
    return ChaosCampaign(
        name=kw.pop("name", "delayed-rejoin"),
        n=n, jobs=jobs,
        faults={worker: FaultSpec(kill_after=at_round)},
        respawn_faults={worker: FaultSpec(ready_delay=ready_delay)},
        note=f"worker {worker} dies at {at_round}, "
             f"rejoin delayed {ready_delay}s",
        **kw,
    )


def partition_heal(n: int, jobs: int, worker: int, *, at_round: int = 3,
                   heal_s: float = 0.8, mode: str = "twoway",
                   **kw) -> ChaosCampaign:
    """One worker drops off the network mid-run and comes back: from
    ``at_round`` its TCP link goes dark (``mode`` picks whether the
    master->worker direction stays open) and heals ``heal_s`` seconds
    later.  The supervisor must classify it PARTITIONED (the process is
    alive), block the gate on the heal, and take the worker back via
    the open-round replay with ZERO respawns — the acceptance gate for
    partition-vs-death discrimination."""
    kw = _bursty_defaults(n, kw)
    kw.setdefault("min_partitions", 1)
    kw.setdefault("min_heals", 1)
    kw.setdefault("max_respawns", 0)
    kw.setdefault("respawn_max_attempts", 3)  # a budget exists — unused
    return ChaosCampaign(
        name=kw.pop("name", "partition-heal"),
        n=n, jobs=jobs,
        transport="tcp",
        net_faults={worker: NetFaultSpec(
            partition_round=at_round, heal_after_s=heal_s,
            partition_mode=mode,
        )},
        note=f"worker {worker} partitioned ({mode}) at round {at_round}, "
             f"heals after {heal_s}s; no respawn allowed",
        **kw,
    )


def lossy_network(n: int, jobs: int, *, latency_s: float = 0.015,
                  jitter_s: float = 0.01, drop_p: float = 0.05,
                  dup_p: float = 0.05, reorder_p: float = 0.1,
                  **kw) -> ChaosCampaign:
    """Every link is bad at once: added latency with jitter plus
    probabilistic drop / duplicate / reorder on every frame.  The
    timeout/resend tier plus mid-filter dedup must deliver every decode
    exactly despite the wire — the generic lossy-datacenter scenario."""
    kw.setdefault("scheme", "gc")
    kw.setdefault("params", {"s": 1})
    cfg_kw = dict(kw.pop("config_kw", {}))
    # drops eat both directions: give the resend tier budget to win
    cfg_kw.setdefault("max_retries", 4)
    cfg_kw.setdefault("round_timeout", 0.3)
    faults = {
        w: NetFaultSpec(latency_s=latency_s, latency_jitter_s=jitter_s,
                        drop_p=drop_p, dup_p=dup_p, reorder_p=reorder_p,
                        seed=w + 1)
        for w in range(n)
    }
    return ChaosCampaign(
        name=kw.pop("name", "lossy-network"),
        n=n, jobs=jobs,
        transport="tcp",
        net_faults=faults,
        config_kw=cfg_kw,
        note=f"all links lossy: +{latency_s * 1e3:.0f}ms(±{jitter_s * 1e3:.0f}) "
             f"drop={drop_p} dup={dup_p} reorder={reorder_p}",
        **kw,
    )


# ---------------------------------------------------------------------------
# execution + audit
# ---------------------------------------------------------------------------


def _delays_for(camp: ChaosCampaign, rounds: int,
                seed: int) -> np.ndarray:
    """Mild i.i.d. planned delays: enough texture that the mu-rule and
    gate stay exercised, small enough that the chaos (not the trace)
    dominates the run."""
    rng = np.random.default_rng([seed, camp.n, camp.jobs])
    delays = rng.uniform(0.0, 0.4, size=(rounds, camp.n))
    # an occasional genuine straggler spike
    spikes = rng.random((rounds, camp.n)) < 0.08
    delays[spikes] += rng.uniform(4.0, 8.0, size=int(spikes.sum()))
    return delays


def run_campaign(camp: ChaosCampaign, *, time_scale: float = 0.02,
                 seed: int = 1) -> CampaignReport:
    """Execute ``camp`` on the real harness and audit the invariants."""
    rounds = camp.jobs + 8
    delays = _delays_for(camp, rounds, seed)
    cfg_kw = dict(
        alpha=8.0,
        time_scale=time_scale,
        seed=seed,
        round_timeout=0.25,
        faults=dict(camp.faults),
        respawn_faults=dict(camp.respawn_faults),
        respawn_max_attempts=camp.respawn_max_attempts,
        respawn_backoff_s=camp.respawn_backoff_s,
        respawn_backoff_max_s=camp.respawn_backoff_max_s,
        degrade=camp.degrade,
        transport=camp.transport,
        net_faults=dict(camp.net_faults),
    )
    cfg_kw.update(camp.config_kw)   # campaign overrides win
    cfg = HarnessConfig(**cfg_kw)
    res = run_harness(camp.scheme, camp.n, camp.jobs, delays,
                      params=dict(camp.params), config=cfg)
    return CampaignReport(campaign=camp.name, result=res,
                          violations=_audit(camp, res))


def _audit(camp: ChaosCampaign, res: HarnessResult) -> list:
    v: list[str] = []
    if camp.expect_abort:
        if not res.aborted:
            v.append("expected the run to abort, but it completed")
        return v
    if res.aborted:
        v.append(f"aborted: {res.abort_reason}")
    want = set(range(1, camp.jobs + 1))
    missing = sorted(want - set(res.decoded_jobs))
    if missing:
        v.append(f"jobs never decoded: {missing}")
    if res.decode_max_err > 1e-6:
        v.append(f"decode error {res.decode_max_err:.2e} > 1e-6")
    led = res.ledger
    if led.rounds != len(res.round_times):
        v.append(
            f"telemetry gap: {led.rounds} ledger rounds vs "
            f"{len(res.round_times)} measured round times"
        )
    degrade_rounds = {ev.get("round") for ev in res.events
                      if ev.get("kind") == "degrade"}
    for rec in led.records:
        if rec.effective_row is None and rec.t not in degrade_rounds:
            v.append(f"round {rec.t}: no committed straggler row")
        for i, st in enumerate(rec.stats):
            if (st.reported is not None and st.sent is not None
                    and st.reported < st.sent):
                v.append(
                    f"round {rec.t} worker {i}: reported before sent"
                )
    if res.respawns < camp.min_respawns:
        v.append(f"respawns {res.respawns} < expected "
                 f">={camp.min_respawns}")
    if res.rejoins < camp.min_rejoins:
        v.append(f"rejoins {res.rejoins} < expected >={camp.min_rejoins}")
    if res.degraded < camp.min_degrades:
        v.append(f"degrades {res.degraded} < expected "
                 f">={camp.min_degrades}")
    if res.partitions < camp.min_partitions:
        v.append(f"partitions {res.partitions} < expected "
                 f">={camp.min_partitions}")
    if res.heals < camp.min_heals:
        v.append(f"heals {res.heals} < expected >={camp.min_heals}")
    if camp.max_respawns is not None and res.respawns > camp.max_respawns:
        v.append(f"spurious respawns: {res.respawns} > "
                 f"allowed {camp.max_respawns} (partition must heal, "
                 "not respawn)")
    return v
