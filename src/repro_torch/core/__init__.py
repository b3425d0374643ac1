"""Coding schemes, gradient codes and the straggler gate of the port.

numpy copies of the parts of ``src/repro/core`` that coded training runs
(``gc.py``, ``schemes.py`` and the numpy gate of ``straggler.py``); the
simulator, the lockstep kernels and the cluster baselines are not ported
yet (ROADMAP.md).
"""

from .gc import DecodingError, GradientCode, RepGradientCode, cyclic_support, make_gradient_code
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
    "ConformanceGate",
    "DecodingError",
    "GCScheme",
    "GilbertElliotSource",
    "GradientCode",
    "JobDecode",
    "MiniTask",
    "MixtureModel",
    "MSGCScheme",
    "NoCodingScheme",
    "PerRoundModel",
    "RepCoverageModel",
    "RepGradientCode",
    "Scheme",
    "SRSGCScheme",
    "WindowwiseOr",
    "cyclic_support",
    "make_gradient_code",
    "make_scheme",
    "register_scheme",
]
