"""Normalized-load formulas and information-theoretic converses (App. F).

Copy of ``src/repro/core/bounds.py`` (the standard library only).
"""

from __future__ import annotations

import math

__all__ = [
    "load_gc",
    "load_sr_sgc",
    "load_m_sgc",
    "lower_bound_bursty",
    "lower_bound_arbitrary",
    "sr_sgc_s",
]


def load_gc(n: int, s: int) -> float:
    """(n,s)-GC normalized load (s+1)/n (§3.1)."""
    return (s + 1) / n


def sr_sgc_s(B: int, W: int, lam: int) -> int:
    """SR-SGC effective per-round tolerance s = ceil(B*lam / (W-1+B))."""
    return math.ceil(B * lam / (W - 1 + B))


def load_sr_sgc(n: int, B: int, W: int, lam: int) -> float:
    return (sr_sgc_s(B, W, lam) + 1) / n


def load_m_sgc(n: int, B: int, W: int, lam: int) -> float:
    """Eq. (1)."""
    if lam < n:
        return (lam + 1) * (W - 1 + B) / (n * (B + (W - 1) * (lam + 1)))
    return (W - 1 + B) / (n * (W - 1))


def lower_bound_bursty(n: int, B: int, W: int, lam: int) -> float:
    """Theorem F.1: converse for any scheme tolerating (B,W,lam)-bursty."""
    if B < W:
        return (W - 1 + B) / (n * (W - 1) + B * (n - lam))
    if B == W:
        return 1.0 / (n - lam)
    raise ValueError("bursty model requires B <= W")


def lower_bound_arbitrary(n: int, N: int, Wp: int, lamp: int) -> float:
    """Theorem F.2: converse for the (N, W', lam')-arbitrary model."""
    if N < Wp:
        return Wp / (n * (Wp - N) + N * (n - lamp))
    if N == Wp:
        return 1.0 / (n - lamp)
    raise ValueError("arbitrary model requires N <= W'")
