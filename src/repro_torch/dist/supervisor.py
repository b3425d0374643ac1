"""Worker-pool supervision: liveness, respawn/rejoin, elastic fleet.

Port of ``src/repro/dist/supervisor.py``.

A master without supervision treats worker death as terminal — an
always-straggler row under per-round models, a hard abort once the gate
has to wait a dead worker out.  :class:`Supervisor` turns ``repro_torch.dist`` into an
elastic substrate instead.  It owns every :class:`WorkerLink` and runs
a per-worker state machine::

    alive --silence--> suspect --pong/result--> alive
      |                   |
      +--process death / retries exhausted--> dead
      |                                        | backoff elapsed,
      | unreachable but                        | attempts < budget
      | process alive                          v
      | (TCP only)                        respawning --ready--> alive
      v                                        |                 ("rejoin")
  partitioned --any message--> alive           +--budget out--> lost
      |        ("heal": open round replayed, NO respawn)
      +--partition_timeout_s--> dead (respawn path as usual)

* **Heartbeats** ride the existing Pipe protocol: when a worker the
  master is waiting on has been silent past ``heartbeat_s`` the
  supervisor sends ``{"kind": "ping"}`` and marks it *suspect*; any
  message back (pong or a result) restores *alive*.  Suspicion never
  changes scheduling — it is the cheap early-warning tier; the master's
  round timeout/retry path stays the authority that declares death.
* **Respawn** is exponential-backoff with jitter and a bounded attempt
  budget (:class:`RespawnPolicy`): a dead worker's replacement process
  is spawned after ``backoff_s * 2^attempt`` (± ``jitter``), re-runs
  the full warmup/readiness sequence of a fresh worker, and only
  rejoins the fleet once its ``ready`` handshake lands.
* **Rejoin replay**: the supervisor ledgers the most recent round
  message dispatched to (or withheld from) every worker; on rejoin it
  replays the entries still in flight (``t >= current round``) so the
  replacement serves the open round immediately instead of idling
  until the next dispatch.
* **Partitioned vs dead** (TCP transport): when a worker is
  unreachable but its *process* is demonstrably alive
  (``link.peer_alive()``), declaring it dead would be wrong — it is
  behind a network partition.  The supervisor parks it in
  *partitioned*: not schedulable, but no respawn is burned.  It keeps
  pinging through the partition; the first message back (a pong, a
  held result flushing) *heals* the worker — back to *alive* with the
  open round replayed from the dispatch ledger, exactly the rejoin
  path minus the respawn.  A partition outlasting
  ``partition_timeout_s`` escalates to the normal death/respawn path.
  Split-brain safe: the master remains the sole gate authority, and
  the TCP host refuses stale-incarnation connections outright.
* **Retire/lost**: budget exhaustion (or an explicit
  :meth:`Supervisor.retire` during adaptive degradation) parks the
  worker in *lost* — never scheduled, never respawned.

Every transition is appended to the shared ``events`` list (the
``RunLedger`` carries it into the ``TraceModel`` v2 recording), stamped
with the master's current round.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from .transport import WorkerLink, start_worker

ALIVE = "alive"
SUSPECT = "suspect"
PARTITIONED = "partitioned"  # unreachable, process alive (TCP only)
DEAD = "dead"              # death detected, respawn scheduled
RESPAWNING = "respawning"  # replacement spawned, awaiting ready
LOST = "lost"              # permanent: budget exhausted or retired


@dataclass(frozen=True)
class RespawnPolicy:
    """Bounded, jittered exponential-backoff respawn budget."""

    max_attempts: int = 0          # 0: death is final
    backoff_s: float = 0.25        # first-retry delay
    backoff_max_s: float = 4.0
    jitter: float = 0.25           # +- fraction of the backoff
    ready_timeout_s: float = 60.0  # respawn that never reports ready
    heartbeat_s: float = 0.5       # silence before a ping / suspicion
    partition_timeout_s: float = 10.0  # partition -> death escalation

    def backoff(self, attempt: int, rng: np.random.Generator) -> float:
        base = min(self.backoff_s * (2.0 ** attempt), self.backoff_max_s)
        return base * (1.0 + self.jitter * float(rng.uniform(-1.0, 1.0)))


class Supervisor:
    """Owns the worker fleet for one harness run (see module docstring).

    ``setup_for(worker_id)`` builds the initial :class:`WorkerSetup`;
    ``respawn_setup_for(worker_id, attempt)`` (optional) builds the
    replacement's — defaulting to the initial setup, so campaigns can
    hand a *different* fault to the respawned incarnation (clean
    rejoin, flapping, delayed ready).
    """

    def __init__(self, n: int, target, setup_for, *,
                 policy: RespawnPolicy | None = None,
                 respawn_setup_for=None,
                 start_method: str = "spawn",
                 events: list | None = None,
                 lost: set[int] | None = None,
                 seed: int = 0,
                 transport: str = "pipe",
                 net_faults: dict | None = None):
        if transport not in ("pipe", "tcp"):
            raise ValueError(f"unknown transport {transport!r}")
        self.n = n
        self.target = target
        self.setup_for = setup_for
        self.respawn_setup_for = respawn_setup_for
        self.policy = policy or RespawnPolicy()
        self.start_method = start_method
        self.events = events if events is not None else []
        self.rng = np.random.default_rng([seed, 0x5eed])
        self.seed = seed
        self.round = 0
        self.transport = transport
        self.net_faults = dict(net_faults or {})
        self.host = None
        if transport == "tcp":
            from .net import TcpHost

            self.host = TcpHost()
        lost = lost or set()
        self.links: list[WorkerLink | None] = [None] * n
        self.state = [LOST if i in lost else ALIVE for i in range(n)]
        self.attempts = [0] * n
        self.respawns = [0] * n
        self.death_count = [0] * n
        self.pings = [0] * n
        self.partition_count = [0] * n
        self.heal_count = [0] * n
        now = time.perf_counter()
        self.last_seen = [now] * n
        self.last_ping = [0.0] * n
        self.next_try = [0.0] * n
        self.ready_deadline = [0.0] * n
        self.partition_since = [0.0] * n
        #: most recent round dispatch per worker: wid -> (t, message)
        self._ledger: dict[int, tuple[int, dict]] = {}
        self._results: list[tuple[int, dict]] = []
        for i in range(n):
            if self.state[i] != LOST:
                self.links[i] = self._spawn(i, setup_for(i))

    def _spawn(self, i: int, setup):
        """Transport-aware process launch (initial fleet + respawns);
        TCP respawns carry the attempt count as their incarnation so
        the host can refuse the predecessor's stale reconnects.  Net
        faults afflict the FIRST incarnation only: escalating a
        partition to a respawn models replacing the unreachable
        machine, so the replacement starts with a clean wire (the
        compute-side analogue is ``respawn_setup_for``)."""
        if self.transport == "tcp":
            from .net import start_worker_tcp

            return start_worker_tcp(
                self.host, i, self.target, setup,
                incarnation=self.attempts[i],
                fault=self.net_faults.get(i) if self.attempts[i] == 0
                else None,
                seed=self.seed,
                start_method=self.start_method,
            )
        return start_worker(i, self.target, setup,
                            start_method=self.start_method)

    # -- queries ---------------------------------------------------------
    def available(self, i: int) -> bool:
        """Schedulable right now (alive or merely suspect)."""
        return self.state[i] in (ALIVE, SUSPECT)

    def recoverable(self, i: int) -> bool:
        """Down, but recovery is plausible: a respawn scheduled or in
        flight, or a partition that may still heal."""
        return self.state[i] in (DEAD, RESPAWNING, PARTITIONED)

    def down_mask(self) -> np.ndarray:
        """(n,) bool: True where the worker cannot serve this instant."""
        return np.array([not self.available(i) for i in range(self.n)])

    def lost_ids(self) -> list[int]:
        return [i for i in range(self.n) if self.state[i] == LOST]

    def ever_died(self) -> list[int]:
        return sorted(i for i in range(self.n) if self.death_count[i] > 0)

    def link(self, i: int) -> WorkerLink | None:
        return self.links[i]

    def counters(self) -> dict:
        return {
            "respawns": list(self.respawns),
            "deaths": list(self.death_count),
            "pings": list(self.pings),
            "partitions": list(self.partition_count),
            "heals": list(self.heal_count),
        }

    # -- lifecycle -------------------------------------------------------
    def begin_round(self, t: int) -> None:
        self.round = t
        for lk in self.links:
            if lk is not None and lk.reconnectable:
                lk.set_round(t)

    def await_ready(self, timeout: float = 120.0) -> None:
        """Initial readiness handshake: block until every non-lost
        worker reported ready, died, or ``timeout`` passed (spawn /
        import / compile cost never counts against round timeouts)."""
        deadline = time.perf_counter() + timeout
        pending = {i for i in range(self.n) if self.state[i] != LOST}
        while pending and time.perf_counter() < deadline:
            self._wait(pending, 0.1)
            for i in list(pending):
                lk = self.links[i]
                while (msg := lk.try_recv()) is not None:
                    if msg.get("kind") == "ready":
                        pending.discard(i)
                        self.last_seen[i] = time.perf_counter()
                if not lk.alive():
                    pending.discard(i)
                    self.mark_dead(i, reason="died before ready")

    def dispatch(self, i: int, t: int, msg: dict) -> bool:
        """Send a round message and ledger it for rejoin replay.  The
        ledger entry is recorded even when the worker is down, so a
        later rejoin can pick the open round up."""
        self._ledger[i] = (t, msg)
        if not self.available(i):
            return False
        ok = self.links[i].send(msg)
        if not ok:
            self.mark_dead(i, reason="send failed")
        return ok

    def resend(self, i: int, msg: dict) -> bool:
        """Retry-path send (no ledger update needed: same round)."""
        if not self.available(i):
            return False
        ok = self.links[i].send(msg)
        if not ok:
            self.mark_dead(i, reason="send failed")
        return ok

    def reconfig(self, bounds) -> None:
        """Ship a new chunk partition to every schedulable worker (and
        remember it for future respawns via the setup hooks)."""
        for i in range(self.n):
            if self.available(i):
                self.links[i].send(
                    {"kind": "reconfig", "bounds": [list(b) for b in bounds]}
                )

    def mark_dead(self, i: int, *, reason: str = "") -> None:
        """Declare a worker unreachable.  When the link can reconnect
        and the worker *process* is demonstrably alive, that is a
        partition, not a death — no respawn is burned; the heal path or
        the ``partition_timeout_s`` escalation in :meth:`tick` settles
        it.  Otherwise: schedule (or exhaust) the respawn."""
        if self.state[i] in (DEAD, RESPAWNING, LOST):
            return
        lk = self.links[i]
        if (self.state[i] != PARTITIONED and lk is not None
                and lk.reconnectable and lk.peer_alive()):
            self.state[i] = PARTITIONED
            self.partition_since[i] = time.perf_counter()
            self.partition_count[i] += 1
            self._event("partition", i, note=reason)
            return
        self.death_count[i] += 1
        self._event("death", i, note=reason)
        if self.links[i] is not None:
            self.links[i].broken = True
        if self.attempts[i] < self.policy.max_attempts:
            self.state[i] = DEAD
            self.next_try[i] = time.perf_counter() + self.policy.backoff(
                self.attempts[i], self.rng
            )
        else:
            self.state[i] = LOST
            self._event("lost", i, note="respawn budget exhausted")

    def give_up(self, i: int) -> None:
        """Hard-deadline escalation: stop waiting on a recovery."""
        if self.state[i] in (DEAD, RESPAWNING, PARTITIONED):
            self._retire_link(i)
            self.state[i] = LOST
            self._event("lost", i, note="recovery deadline passed")

    def retire(self, i: int) -> None:
        """Remove a worker from the fleet for good (degradation path)."""
        if self.state[i] == LOST:
            return
        self._retire_link(i)
        self.state[i] = LOST
        self._event("lost", i, note="retired")

    def tick(self, waiting_on=()) -> None:
        """One supervision step: fire due respawns, time out stalled
        rejoins, and heartbeat the workers the master is blocked on."""
        now = time.perf_counter()
        hb = self.policy.heartbeat_s
        for i in range(self.n):
            st = self.state[i]
            if st == DEAD and now >= self.next_try[i]:
                self._respawn(i)
            elif st == RESPAWNING:
                lk = self.links[i]
                if lk is not None and not lk.alive():
                    # the replacement died before ready: next attempt
                    self.state[i] = ALIVE  # let mark_dead re-enter
                    self.mark_dead(i, reason="respawn died before ready")
                elif now > self.ready_deadline[i]:
                    self.give_up(i)
            elif st == PARTITIONED:
                lk = self.links[i]
                if lk is None or not lk.peer_alive():
                    self.mark_dead(i, reason="partitioned process died")
                elif (now - self.partition_since[i]
                        > self.policy.partition_timeout_s):
                    # unreachable past the suspicion deadline: kill the
                    # stranded process and take the normal respawn path
                    lk.kill()
                    self.mark_dead(i, reason="partition timeout")
                elif (now - self.last_ping[i] > hb):
                    # keep probing THROUGH the partition: the first
                    # ping that gets a pong back is the heal signal
                    if lk.send({"kind": "ping", "seq": self.round}):
                        self.last_ping[i] = now
                        self.pings[i] += 1
        for i in waiting_on:
            if (self.state[i] == ALIVE and now - self.last_seen[i] > hb
                    and now - self.last_ping[i] > hb):
                if self.links[i].send({"kind": "ping", "seq": self.round}):
                    self.state[i] = SUSPECT
                    self.last_ping[i] = now
                    self.pings[i] += 1

    def pump(self) -> list[tuple[int, dict]]:
        """Drain every link; handle ready/pong internally, detect silent
        process deaths, and return the result messages as
        ``(worker_id, message)`` pairs."""
        out = []
        for i in range(self.n):
            lk = self.links[i]
            if lk is None:
                continue
            while (msg := lk.try_recv()) is not None:
                kind = msg.get("kind")
                self.last_seen[i] = time.perf_counter()
                if self.state[i] == PARTITIONED:
                    # any message through the wire IS the heal signal
                    self._heal(i)
                if kind == "ready":
                    if self.state[i] == RESPAWNING:
                        self._rejoin(i)
                elif kind == "pong":
                    if self.state[i] == SUSPECT:
                        self.state[i] = ALIVE
                elif kind == "result":
                    if self.state[i] == SUSPECT:
                        self.state[i] = ALIVE
                    out.append((i, msg))
            if self.state[i] in (ALIVE, SUSPECT) and not lk.alive():
                self.mark_dead(i, reason="process died")
        return out

    def stop(self) -> None:
        # every worker is told first, so the fleet winds down in parallel
        # (a grad-mode worker takes seconds to free its device state); then
        # each link's own stop joins, and terminates a straggler
        for lk in self.links:
            if lk is not None:
                lk.send({"kind": "stop"})
        for lk in self.links:
            if lk is not None:
                lk.stop()
        if self.host is not None:
            self.host.close()

    # -- internals -------------------------------------------------------
    def _event(self, kind: str, worker: int, *, note: str = "") -> None:
        ev = {"round": int(self.round), "worker": int(worker),
              "kind": kind}
        if note:
            ev["note"] = note
        self.events.append(ev)

    def _retire_link(self, i: int) -> None:
        if self.links[i] is not None:
            self.links[i].kill()

    def _setup(self, i: int):
        if self.respawn_setup_for is not None:
            return self.respawn_setup_for(i, self.attempts[i])
        return self.setup_for(i)

    def _respawn(self, i: int) -> None:
        self._retire_link(i)
        self.attempts[i] += 1
        self.respawns[i] += 1
        self._event("respawn", i, note=f"attempt {self.attempts[i]}")
        self.links[i] = self._spawn(i, self._setup(i))
        self.state[i] = RESPAWNING
        self.ready_deadline[i] = (
            time.perf_counter() + self.policy.ready_timeout_s
        )

    def _replay_open(self, i: int) -> None:
        """Replay the open round from the assignment ledger so the
        returning worker serves it immediately (attempt=1: resend
        semantics, exempt from first-attempt drop faults)."""
        entry = self._ledger.get(i)
        if entry is not None and entry[0] >= self.round:
            msg = dict(entry[1])
            msg["attempt"] = max(1, int(msg.get("attempt", 0)))
            self.links[i].send(msg)

    def _rejoin(self, i: int) -> None:
        self.state[i] = ALIVE
        self.last_seen[i] = time.perf_counter()
        self._event("rejoin", i)
        self._replay_open(i)

    def _heal(self, i: int) -> None:
        """A partitioned worker reached us again: back to the fleet
        with the open round replayed — same catch-up as a rejoin, but
        the SAME process and no respawn burned."""
        self.state[i] = ALIVE
        self.last_seen[i] = time.perf_counter()
        self.heal_count[i] += 1
        self._event("heal", i)
        self._replay_open(i)

    def _wait(self, ids, timeout: float) -> None:
        from .transport import wait_any

        wait_any([self.links[i] for i in ids
                  if self.links[i] is not None], timeout)
