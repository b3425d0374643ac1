"""Multi-model interleaved coded-training drivers (paper §4.2 / App. I).
Port of ``src/repro/train/driver.py``.

Trains M models concurrently: job ``M*i + j`` is step-i of model-j
(Remark 2.1), so a scheme with delay T <= M-1 never stalls an update.
The drivers run the full master protocol with real numerics:

    round-t:  tasks = scheme.assign(t)
              stragglers <- delay profile + mu-rule + Remark-2.3 wait-out
              non-straggler tasks execute REAL chunk gradients (at the
              parameter snapshot of the job's issue round)
              scheme.collect(t) -> decoded gradient -> AdamW update

The wall clock is simulated from the delay profile, expression for
expression as the JAX package does, so runtimes are comparable across
schemes (and with the JAX package) while the training itself is genuine.

* :class:`CodedTrainingDriver` — the descriptor path: it executes each
  mini-task's chunk gradients eagerly; its GC encode (a worker's coded
  combination of its chunk gradients) and its decode (the survivors'
  weighted sum) are each one ``coded_combine`` kernel launch on the card.
* :class:`VectorizedCodedTrainer` — the production loop: each decodable
  job is ONE ``make_coded_train_step`` call on the (n, slots) replicated
  batch view, whose weighted loss is the decoder.  Any token model whose
  backward runs on the card trains here: the dense, moe, ssm and hybrid
  families (``seq_len`` sets the sequence, so several of a Mamba2 model's
  chunks, and the state carried between them, can be trained).
* :func:`run_adaptive` — App. K.2 / Fig. 18: train uncoded for a probe
  phase, select coding parameters from the observed delays with the
  lockstep simulator (``core.select_parameters``, on the device), then
  train coded with the same model states.
"""

from __future__ import annotations

from dataclasses import dataclass, field
import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.schemes import MSGCScheme, Scheme, make_scheme
from repro_torch.core.simulator import select_parameters
from repro_torch.core.straggler import ConformanceGate
from repro_torch.data import (
    chunk_boundaries,
    classification_batch,
    coded_slot_batch,
    token_batch,
)
from repro_torch.devices import resolve_device
from repro_torch.kernels.gc_coding import coded_combine_tree
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.tree import tree_map

from .coded import init_train_state, make_coded_train_step, value_and_grad


def _round_clock(gate: ConformanceGate, times: np.ndarray, mu: float):
    """One round of the mu-rule and the Remark-2.3 wait-out gate.

    Returns (effective straggler row, the round's simulated duration); the
    expressions are the JAX package's, so its clocks and these agree.
    """
    kappa = float(times.min())
    cutoff = (1.0 + mu) * kappa
    cand = times > cutoff
    if not cand.any():
        gate.force(cand)
        return cand, float(min(cutoff, times.max()))
    cand, waited = gate.admit_partial(cand, times)
    base = float(min(cutoff, times.max())) if cand.any() else cutoff
    return cand, (float(max(times[waited].max(), base)) if waited else base)


# ---------------------------------------------------------------------------
# A small model for the descriptor-path driver (the paper trains CNNs; an
# MLP classifier keeps the rounds fast — the protocol is identical).
# ---------------------------------------------------------------------------


@dataclass
class MLPModel:
    dim: int = 64
    hidden: int = 128
    classes: int = 10

    def init(self, gen: torch.Generator) -> dict:
        """f32 parameters drawn from ``gen``, on ``gen.device``."""
        dev = gen.device
        return {
            "w1": torch.randn((self.dim, self.hidden), generator=gen, device=dev)
            * self.dim ** -0.5,
            "b1": torch.zeros((self.hidden,), device=dev),
            "w2": torch.randn((self.hidden, self.classes), generator=gen, device=dev)
            * self.hidden ** -0.5,
            "b2": torch.zeros((self.classes,), device=dev),
        }

    def loss_sum(self, params, x, y):
        h = F.relu(x @ params["w1"] + params["b1"])
        logits = h @ params["w2"] + params["b2"]
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(-1, y[:, None]).sum()

    def loss_mean(self, params, x, y):
        return self.loss_sum(params, x, y) / x.shape[0]


@dataclass
class CodedTrainingDriver:
    scheme: Scheme
    num_models: int
    model: MLPModel = field(default_factory=MLPModel)
    batch_size: int = 256
    lr: float = 1e-2
    mu: float = 1.0
    alpha: float = 8.0
    seed: int = 0
    device: object = "cuda"

    def __post_init__(self):
        if self.scheme.T > self.num_models - 1:
            raise ValueError(
                f"delay T={self.scheme.T} needs at least T+1="
                f"{self.scheme.T + 1} interleaved models (Remark 2.1)"
            )
        self.device = resolve_device(self.device)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.params = [self.model.init(gen) for _ in range(self.num_models)]
        self.opt = [adamw_init(p) for p in self.params]
        self._snapshots: dict[int, dict] = {}     # job -> params snapshot
        self._chunk_grads: dict[tuple, dict] = {}
        self._results: dict[tuple, dict] = {}
        self.losses: dict[int, list] = {m: [] for m in range(self.num_models)}
        self.job_done_time: dict[int, float] = {}
        self.compute_units = 0.0                  # normalized-load ledger
        self.encodes = 0                          # coded combines of the workers
        self.decodes = 0                          # coded combines of the master

    # -- data ------------------------------------------------------------
    def _job_batch(self, job: int):
        return classification_batch(self.seed, job, self.batch_size, self.model.dim,
                                    self.model.classes, device=self.device)

    def _chunks(self):
        if isinstance(self.scheme, MSGCScheme):
            fr = [self.scheme.chunk_fraction(c) for c in range(self.scheme.num_chunks)]
            return chunk_boundaries(self.batch_size, fr)
        n = self.scheme.n
        return chunk_boundaries(self.batch_size, [1.0 / n] * n)

    def _grad_sum(self, params, x, y):
        return value_and_grad(lambda p: self.model.loss_sum(p, x, y), params)[1]

    def _chunk_grad(self, job: int, chunk: int):
        key = (job, chunk)
        if key not in self._chunk_grads:
            x, y = self._job_batch(job)
            lo, hi = self._chunks()[chunk]
            self._chunk_grads[key] = self._grad_sum(self._snapshots[job], x[lo:hi], y[lo:hi])
        return self._chunk_grads[key]

    def _task_load(self, mt) -> float:
        """Normalized data fraction a mini-task costs its worker."""
        bounds = self._chunks()
        if mt.kind == "ell":
            sup = np.flatnonzero(self.scheme.code.encode_matrix[mt.worker])
            return sum(bounds[c][1] - bounds[c][0] for c in sup) / self.batch_size
        if mt.kind in ("d1", "all"):
            lo, hi = bounds[mt.chunk]
            return (hi - lo) / self.batch_size
        if mt.kind == "d2":
            sch = self.scheme
            base = (sch.W - 1) * sch.n + mt.chunk * sch.n
            loc = np.flatnonzero(sch.code.encode_matrix[mt.worker])
            return sum(
                bounds[base + c][1] - bounds[base + c][0] for c in loc
            ) / self.batch_size
        return 0.0

    # -- protocol ----------------------------------------------------------
    def run(self, J: int, delays: np.ndarray):
        """Run J jobs; delays: (>= J+T rounds, n) reference profile."""
        sch = self.scheme
        n = sch.n
        extra = (sch.normalized_load - 1.0 / n) * self.alpha
        gate = ConformanceGate(sch.design_model, n)
        clock = 0.0
        for t in range(1, J + sch.T + 1):
            # snapshot params for the job issued this round
            if 1 <= t <= J:
                midx = (t - 1) % self.num_models
                self._snapshots[t] = tree_map(torch.clone, self.params[midx])
            tasks = sch.assign(t)
            cand, dt = _round_clock(gate, delays[t - 1] + extra, self.mu)
            clock += dt
            self._execute(tasks, cand)
            sch.observe(t, cand)
            for jd in sch.collect(t):
                self._apply_update(jd)
                self.job_done_time[jd.job] = clock
        missing = [j for j in range(1, J + 1) if j not in self.job_done_time]
        assert not missing, f"jobs unfinished: {missing[:4]}"
        return clock

    # -- numeric task execution ------------------------------------------
    def _encode(self, job: int, chunks, coeffs):
        self.encodes += 1
        return _tree_weighted_sum([self._chunk_grad(job, int(c)) for c in chunks], coeffs)

    def _execute(self, tasks, stragglers):
        for mt in tasks:
            if mt.trivial:
                continue
            # assigned work costs compute whether or not the worker
            # straggles (cancelled tasks still burned the cycles)
            self.compute_units += self._task_load(mt)
            if stragglers[mt.worker]:
                continue
            if mt.kind == "ell":
                row = self.scheme.code.encode_matrix[mt.worker]
                sup = np.flatnonzero(row)
                self._results[("ell", mt.job, mt.worker)] = self._encode(mt.job, sup, row[sup])
            elif mt.kind in ("d1", "all"):
                self._results[("d1", mt.job, mt.chunk)] = self._chunk_grad(mt.job, mt.chunk)
            elif mt.kind == "d2":
                sch = self.scheme
                base = (sch.W - 1) * sch.n + mt.chunk * sch.n
                coeffs = sch.code.encode_matrix[mt.worker]
                loc = np.flatnonzero(coeffs)
                self._results[("d2", mt.job, mt.chunk, mt.worker)] = self._encode(
                    mt.job, base + loc, coeffs[loc])

    def decode_gradient(self, jd):
        sch = self.scheme
        self.decodes += 1
        if jd.ell_weights:
            parts = [self._results[("ell", jd.job, i)] for i in jd.ell_weights]
            return _tree_weighted_sum(parts, list(jd.ell_weights.values()))
        if isinstance(sch, MSGCScheme):
            parts = [
                self._results[("d1", jd.job, sch.d1_chunk(i, l))]
                for i in range(sch.n)
                for l in range(sch.W - 1)
            ]
            weights = [1.0] * len(parts)
            for m, ws in jd.group_weights.items():
                for i, w in ws.items():
                    parts.append(self._results[("d2", jd.job, m, i)])
                    weights.append(w)
            return _tree_weighted_sum(parts, weights)
        parts = [self._results[("d1", jd.job, c)] for c in range(sch.n)]
        return _tree_weighted_sum(parts, [1.0] * sch.n)

    def _apply_update(self, jd):
        g = tree_map(lambda x: x / self.batch_size, self.decode_gradient(jd))
        midx = (jd.job - 1) % self.num_models
        self.params[midx], self.opt[midx] = adamw_update(
            self.params[midx], g, self.opt[midx], lr=self.lr
        )
        x, y = self._job_batch(jd.job)
        with torch.no_grad():
            self.losses[midx].append(float(self.model.loss_mean(self.params[midx], x, y)))

    # -- validation hook ----------------------------------------------------
    def full_gradient(self, job: int):
        """Direct full-batch gradient at the job's snapshot (oracle)."""
        x, y = self._job_batch(job)
        return self._grad_sum(self._snapshots[job], x, y)


def run_adaptive(
    num_models: int,
    J: int,
    delays: np.ndarray,
    *,
    scheme_name: str = "m-sgc",
    t_probe: int = 20,
    batch_size: int = 256,
    lr: float = 1e-2,
    mu: float = 1.0,
    alpha: float = 8.0,
    seed: int = 0,
    grid=None,
    device="cuda",
):
    """App. K.2 / Fig. 18: start training UNCODED, after ``t_probe``
    rounds select coding parameters from the observed delay profile and
    switch to the coded scheme for the remaining jobs.  Training and the
    selection's lockstep simulation both run on ``device``.

    Returns (total_clock, probe_clock, selected_params, driver) — model
    parameters carry over across the switch, so no training progress is
    lost to the probe phase.
    """
    n = delays.shape[1]
    # phase 1: uncoded probe (records the reference delay profile)
    probe_sch = make_scheme("uncoded", n, t_probe)
    drv = CodedTrainingDriver(
        scheme=probe_sch, num_models=num_models, batch_size=batch_size,
        lr=lr, mu=mu, alpha=alpha, seed=seed, device=device,
    )
    probe_clock = drv.run(t_probe, delays[:t_probe])

    # phase 2: App-J selection on the probe profile
    cand = select_parameters(
        scheme_name, n, delays[:t_probe], mu=mu, alpha=alpha, grid=grid, device=device,
    )

    # phase 3: coded training continues with the SAME model states
    rest = J - t_probe
    coded_sch = make_scheme(scheme_name, n, rest, **cand.params)
    drv2 = CodedTrainingDriver(
        scheme=coded_sch, num_models=num_models, batch_size=batch_size,
        lr=lr, mu=mu, alpha=alpha, seed=seed + 1, device=device,
    )
    drv2.params = drv.params          # carry over model states
    drv2.opt = drv.opt
    coded_clock = drv2.run(rest, delays[t_probe : t_probe + rest + coded_sch.T])
    return probe_clock + coded_clock, probe_clock, cand.params, drv2


@dataclass
class VectorizedCodedTrainer:
    """Multi-model coded trainer over the replicated-batch coded step.

    Trains ``num_models`` transformer LMs (``cfg``) concurrently on
    deterministic ``token_batch`` streams; job-t belongs to model
    ``(t-1) % num_models``.  The straggler gate (mu-rule + Remark-2.3
    wait-out) and the simulated wall clock match the JAX package's
    expression for expression.  ``batch_size`` must be divisible by
    ``scheme.chunk_grid()[0]``.
    """

    scheme: Scheme
    cfg: object                       # models.config.ModelConfig
    num_models: int
    batch_size: int = 32
    seq_len: int = 16
    lr: float = 1e-4
    mu: float = 1.0
    alpha: float = 8.0
    seed: int = 0
    device: object = "cuda"

    def __post_init__(self):
        sch = self.scheme
        if sch.T > self.num_models - 1:
            raise ValueError(
                f"delay T={sch.T} needs at least T+1={sch.T + 1} "
                "interleaved models (Remark 2.1)"
            )
        self.num_chunks, self.slots = sch.chunk_grid()
        if self.batch_size % self.num_chunks:
            raise ValueError(
                f"batch_size {self.batch_size} not divisible by "
                f"num_chunks {self.num_chunks} ({sch.name})"
            )
        self.device = resolve_device(self.device)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        states = [init_train_state(self.cfg, gen) for _ in range(self.num_models)]
        self.params = [p for p, _ in states]
        self.opt = [o for _, o in states]
        self._step = make_coded_train_step(
            self.cfg, sch.n, getattr(sch, "s", 0), lr=self.lr,
            num_chunks=self.num_chunks,
        )
        self.losses: dict[int, list] = {m: [] for m in range(self.num_models)}
        self.job_done_time: dict[int, float] = {}

    def _job_batch(self, job: int):
        return token_batch(self.seed, job, self.batch_size, self.seq_len,
                           self.cfg.vocab_size, device=self.device)

    def _apply(self, jd) -> None:
        """Decode job ``jd`` as one coded step: gather the job's batch into
        the (n, slots) view, feed the scheme's solved decode weights, update
        that model in place."""
        sch = self.scheme
        coded = coded_slot_batch(self._job_batch(jd.job), sch.chunk_slots(jd.job),
                                 self.num_chunks)
        w = torch.from_numpy(sch.decode_weights(jd)).to(self.device)
        midx = (jd.job - 1) % self.num_models
        self.params[midx], self.opt[midx], metrics = self._step(
            self.params[midx], self.opt[midx], coded, w
        )
        self.losses[midx].append(float(metrics["loss"]))

    def run(self, J: int, delays: np.ndarray) -> float:
        """Run J jobs against the (>= J+T rounds, n) delay profile; returns
        the simulated wall clock."""
        sch = self.scheme
        extra = (sch.normalized_load - 1.0 / sch.n) * self.alpha
        gate = ConformanceGate(sch.design_model, sch.n)
        clock = 0.0
        for t in range(1, J + sch.T + 1):
            cand, dt = _round_clock(gate, delays[t - 1] + extra, self.mu)
            clock += dt
            sch.step(t, cand)
            for jd in sch.collect_decodes(t):
                self._apply(jd)
                self.job_done_time[jd.job] = clock
        missing = [j for j in range(1, J + 1) if j not in self.job_done_time]
        assert not missing, f"jobs unfinished: {missing[:4]}"
        return clock


def _tree_weighted_sum(trees, weights):
    """sum_k weights[k] * trees[k], leaf-wise: one ``coded_combine`` over the
    trees stacked on a leading axis (one kernel launch on the card)."""
    stacked = tree_map(lambda *leaves: torch.stack(leaves), *trees)
    return coded_combine_tree(stacked, [float(w) for w in weights])
