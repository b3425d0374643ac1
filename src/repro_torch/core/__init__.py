"""Coding schemes, gradient codes, straggler models and the simulator of the port.

Port of ``src/repro/core``: ``gc.py``, ``schemes.py`` and ``straggler.py``
(numpy bookkeeping on the host, with the models' batched hooks on torch
tensors), the lockstep kernels and gate of ``kernel.py``, the lockstep engine
of ``batch.py`` and the App.-J selection of ``simulator.py``.  The engine runs
on the card unless the caller passes ``device="cpu"``.  The clustered
baselines (dc-gc, sb-gc), the trace library and the grid-fused engine are not
ported yet (ROADMAP.md).
"""

from .batch import (
    RoundPrecompute,
    precompute_rounds,
    select_parameters_fast,
    simulate_batch,
    simulate_fast,
    simulate_lockstep,
)
from .gc import DecodingError, GradientCode, RepGradientCode, cyclic_support, make_gradient_code
from .kernel import (
    GateKernel,
    GateState,
    GCKernel,
    MSGCKernel,
    SchemeKernel,
    SchemeState,
    SRSGCKernel,
    UncodedKernel,
    has_kernel,
    kernel_seed_sensitive,
    make_kernel,
    register_kernel,
)
from .schemes import (
    GCScheme,
    JobDecode,
    MiniTask,
    MSGCScheme,
    NoCodingScheme,
    Scheme,
    SRSGCScheme,
    make_scheme,
    register_scheme,
)
from .simulator import (
    Candidate,
    SimResult,
    default_grid,
    estimate_alpha,
    params_delay,
    reference_profile,
    select_parameters,
    select_parameters_legacy,
    simulate,
)
from .straggler import (
    ArbitraryModel,
    BurstyModel,
    ConformanceGate,
    GilbertElliotSource,
    MixtureModel,
    PerRoundModel,
    RepCoverageModel,
    WindowwiseOr,
)

__all__ = [
    "ArbitraryModel",
    "BurstyModel",
    "Candidate",
    "ConformanceGate",
    "DecodingError",
    "GateKernel",
    "GateState",
    "GCKernel",
    "GCScheme",
    "GilbertElliotSource",
    "GradientCode",
    "JobDecode",
    "MiniTask",
    "MixtureModel",
    "MSGCKernel",
    "MSGCScheme",
    "NoCodingScheme",
    "PerRoundModel",
    "RepCoverageModel",
    "RepGradientCode",
    "RoundPrecompute",
    "Scheme",
    "SchemeKernel",
    "SchemeState",
    "SimResult",
    "SRSGCKernel",
    "SRSGCScheme",
    "UncodedKernel",
    "WindowwiseOr",
    "cyclic_support",
    "default_grid",
    "estimate_alpha",
    "has_kernel",
    "kernel_seed_sensitive",
    "make_gradient_code",
    "make_kernel",
    "make_scheme",
    "params_delay",
    "precompute_rounds",
    "reference_profile",
    "register_kernel",
    "register_scheme",
    "select_parameters",
    "select_parameters_fast",
    "select_parameters_legacy",
    "simulate",
    "simulate_batch",
    "simulate_fast",
    "simulate_lockstep",
]
