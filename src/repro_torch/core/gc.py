"""Gradient Coding (Tandon et al., 2017) primitives.

Copy of ``src/repro/core/gc.py`` (numpy only): ``cyclic_support``,
``DecodingError``, ``GradientCode``, ``RepGradientCode``,
``ClusterGradientCode`` (the code of the dc-gc / sb-gc baselines) and
``make_gradient_code``.

* ``GradientCode`` — an (n, s) code with cyclic support: worker-i holds
  data chunks ``[i : i+s]* (mod n)`` and returns one linear combination
  ``l_i = sum_j alpha_{i,j} g_j``.  The master recovers
  ``g = g_0 + ... + g_{n-1}`` from *any* ``n - s`` task results.
* ``RepGradientCode`` — the App.-G "GC-Rep" simplification, valid when
  ``(s+1) | n``: workers are split into ``n/(s+1)`` replication groups,
  every member of a group returns the plain sum of the group's chunks,
  decode is the trivial sum of one survivor per group.

All coefficient algebra is float64 on the host; kernels consume float32.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "cyclic_support",
    "GradientCode",
    "RepGradientCode",
    "ClusterGradientCode",
    "make_gradient_code",
]


def cyclic_support(i: int, s: int, n: int) -> np.ndarray:
    """Chunk indices ``[i : i+s]* = {i, i+1, ..., i+s} mod n`` (paper §3.1)."""
    return (i + np.arange(s + 1)) % n


class DecodingError(RuntimeError):
    """Raised when a survivor set cannot decode the full gradient."""


@dataclass
class GradientCode:
    """General (n, s) gradient code with cyclic chunk placement.

    Attributes
    ----------
    n : number of workers (== number of data chunks)
    s : straggler tolerance; each worker computes ``s + 1`` partial
        gradients (normalized load ``(s+1)/n``).
    encode_matrix : (n, n) float64, row i supported on ``[i : i+s]*``.
    """

    n: int
    s: int
    seed: int = 0
    _decode_cache: dict = field(init=False, repr=False, default_factory=dict)

    def __post_init__(self) -> None:
        if not 0 <= self.s < self.n:
            raise ValueError(f"need 0 <= s < n, got s={self.s}, n={self.n}")
        self._matrix: np.ndarray | None = None

    @property
    def encode_matrix(self) -> np.ndarray:
        """Built (and verified) lazily: the load-only simulation fast
        path never touches coefficients, so pure-capacity checks skip
        the O(n) solve + verification entirely."""
        if self._matrix is None:
            self._matrix = self._build_verified()
        return self._matrix

    # -- construction ---------------------------------------------------
    def _build(self, seed: int) -> np.ndarray:
        """Tandon et al. (2017) Algorithm 2.

        Draw H in R^{s x n} Gaussian with columns summing to zero, then
        pick each row of B (cyclic support s+1) inside null(H).  Since
        H @ 1 = 0, the all-ones vector lies in null(H); any n-s rows of
        B are generically independent, hence span null(H) and decode.
        """
        rng = np.random.default_rng(seed)
        n, s = self.n, self.s
        H = rng.standard_normal((s, n))
        H[:, -1] = -H[:, :-1].sum(axis=1)
        B = np.zeros((n, n), dtype=np.float64)
        for i in range(n):
            sup = cyclic_support(i, s, n)
            j0, rest = sup[0], sup[1:]
            x = np.linalg.solve(H[:, rest], -H[:, j0])
            B[i, j0] = 1.0
            B[i, rest] = x
        return B

    def _build_verified(self) -> np.ndarray:
        for attempt in range(8):
            B = self._build(self.seed + attempt)
            if self._verify(B):
                return B
        raise RuntimeError("could not build a decodable gradient code")

    def _verify(self, B: np.ndarray, max_checks: int = 64) -> bool:
        k = self.n - self.s
        idx = range(self.n)
        all_subsets = None
        from math import comb

        if comb(self.n, k) <= max_checks:
            all_subsets = list(itertools.combinations(idx, k))
        rng = np.random.default_rng(self.seed ^ 0xC0DE)
        subsets = all_subsets or [
            tuple(np.sort(rng.choice(self.n, size=k, replace=False)))
            for _ in range(max_checks)
        ]
        for sub in subsets:
            try:
                self._solve(B, np.asarray(sub))
            except DecodingError:
                return False
        return True

    # -- decoding -------------------------------------------------------
    @staticmethod
    def _solve(B: np.ndarray, survivors: np.ndarray) -> np.ndarray:
        """Find a with a^T B[survivors] = 1^T; raise if inconsistent."""
        n = B.shape[0]
        Bs = B[survivors]  # (m, n)
        a, *_ = np.linalg.lstsq(Bs.T, np.ones(n), rcond=None)
        if not np.allclose(Bs.T @ a, np.ones(n), atol=1e-6):
            raise DecodingError(f"survivor set {survivors} cannot decode")
        return a

    def decode_vector(self, survivors) -> np.ndarray:
        """Length-n decode weights beta (zero at non-survivors) with
        ``g = sum_i beta_i l_i`` for any survivor set of size >= n - s."""
        survivors = np.asarray(sorted(survivors), dtype=np.int64)
        if survivors.size < self.n - self.s:
            raise DecodingError(
                f"{survivors.size} survivors < n - s = {self.n - self.s}"
            )
        key = tuple(survivors.tolist())
        hit = self._decode_cache.get(key)
        if hit is None:
            a = self._solve(self.encode_matrix, survivors)
            beta = np.zeros(self.n, dtype=np.float64)
            beta[survivors] = a
            hit = self._decode_cache[key] = beta
        return hit.copy()

    # -- bookkeeping ------------------------------------------------------
    def chunks_of_worker(self, i: int) -> np.ndarray:
        return cyclic_support(i, self.s, self.n)

    def can_decode(self, survivors) -> bool:
        return len(set(survivors)) >= self.n - self.s

    def can_decode_mask(self, survivors: np.ndarray) -> bool:
        """Decodability from a bool[n] survivor mask (load-only fast path)."""
        return int(survivors.sum()) >= self.n - self.s

    def can_decode_mask_batch(self, survivors):
        """Batched ``can_decode_mask``: ``(..., n)`` bool -> ``(...,)``
        bool, for a numpy array or a torch tensor on any device (the
        lockstep kernels, ``core.kernel``)."""
        return survivors.sum(axis=-1) >= self.n - self.s

    @property
    def normalized_load(self) -> float:
        return (self.s + 1) / self.n


@dataclass
class RepGradientCode:
    """App.-G GC-Rep: fractional-repetition code, requires (s+1) | n.

    Workers are split into ``n/(s+1)`` groups; group-k members all
    compute ``sum of chunks [k(s+1) : (k+1)(s+1)-1]`` and return it
    verbatim.  Decoding = sum of one survivor per group (coefficient 1).
    Tolerates *any* pattern leaving >= 1 survivor per group (a strict
    superset of the s-per-round patterns).
    """

    n: int
    s: int

    def __post_init__(self) -> None:
        if (self.n % (self.s + 1)) != 0:
            raise ValueError("GC-Rep requires (s+1) | n")
        self._matrix: np.ndarray | None = None

    @property
    def encode_matrix(self) -> np.ndarray:
        """Built lazily: the load-only fast path only needs group
        coverage, not the n x n replication matrix."""
        if self._matrix is None:
            B = np.zeros((self.n, self.n), dtype=np.float64)
            g = self.s + 1
            for i in range(self.n):
                k = i // g
                B[i, k * g : (k + 1) * g] = 1.0
            self._matrix = B
        return self._matrix

    @property
    def num_groups(self) -> int:
        return self.n // (self.s + 1)

    def group_of(self, i: int) -> int:
        return i // (self.s + 1)

    def chunks_of_worker(self, i: int) -> np.ndarray:
        k = self.group_of(i)
        return np.arange(k * (self.s + 1), (k + 1) * (self.s + 1))

    def decode_vector(self, survivors) -> np.ndarray:
        surv = sorted(survivors)
        beta = np.zeros(self.n, dtype=np.float64)
        seen: set[int] = set()
        for w in surv:
            k = self.group_of(w)
            if k not in seen:
                beta[w] = 1.0
                seen.add(k)
        if len(seen) != self.num_groups:
            raise DecodingError("some replication group has no survivor")
        return beta

    def can_decode(self, survivors) -> bool:
        """App. G: decodable iff every replication group has a survivor
        — a strict SUPERSET of the any-(n-s) rule."""
        groups = {self.group_of(w) for w in survivors}
        return len(groups) == self.num_groups

    def can_decode_mask(self, survivors: np.ndarray) -> bool:
        """Decodability from a bool[n] survivor mask (load-only fast path)."""
        return bool(
            survivors.reshape(self.num_groups, self.s + 1).any(axis=1).all()
        )

    def can_decode_mask_batch(self, survivors):
        """Batched ``can_decode_mask``: one survivor per replication
        group, vectorized over any leading axes of a numpy array or a
        torch tensor."""
        shaped = survivors.reshape(
            survivors.shape[:-1] + (self.num_groups, self.s + 1)
        )
        return shaped.any(axis=-1).all(axis=-1)

    @property
    def normalized_load(self) -> float:
        return (self.s + 1) / self.n


class ClusterGradientCode:
    """Cluster-structured gradient code (the dc-gc / sb-gc baselines).

    Workers are partitioned into equal clusters by ``cid`` (int[n],
    values in [0, C)); each cluster of size ``g = n/C`` owns the data
    chunks of its own members and is protected by a within-cluster
    (g, s) code — fractional repetition (App.-G GC-Rep) when
    ``(s+1) | g``, the general Tandon construction otherwise.  All
    clusters share ONE inner (g, g) matrix; the global ``encode_matrix``
    embeds it at each cluster's member/chunk block, so worker-i's row is
    supported on ``s+1`` chunks of its own cluster and the per-worker
    load is ``(s+1)/n`` exactly like an (n, s)-GC.

    Decoding is per cluster: the decode vector is solved from the
    round-t survivors *within* each cluster (``a^T B_c[surv] = 1^T``),
    and the global beta is the concatenation — job-t decodes iff every
    cluster can, which the per-cluster ``DecodingError`` reports with
    the cluster's survivor count.
    """

    def __init__(self, cid, s: int, *, prefer_rep: bool = True,
                 seed: int = 0):
        cid = np.asarray(cid, dtype=np.int64)
        n = cid.size
        C = int(cid.max()) + 1 if n else 0
        members = [np.flatnonzero(cid == c) for c in range(C)]
        sizes = {m.size for m in members}
        if len(sizes) != 1:
            raise ValueError(f"clusters must be equal-sized, got {sizes}")
        g = sizes.pop()
        if not 0 <= s < g:
            raise ValueError(f"need 0 <= s < cluster size {g}, got s={s}")
        self.n, self.s, self.C = n, s, C
        self.cid = cid
        self.members = members
        #: local rank of worker i within its cluster (members are in
        #: worker order, so rank = position in the sorted member list)
        self.local_rank = np.empty(n, dtype=np.int64)
        for m in members:
            self.local_rank[m] = np.arange(g)
        self.inner = make_gradient_code(g, s, prefer_rep=prefer_rep,
                                        seed=seed)
        self._matrix: np.ndarray | None = None

    @property
    def encode_matrix(self) -> np.ndarray:
        """(n, n) float64, the inner matrix embedded per cluster: row i
        is supported on the chunks of worker-i's cluster members."""
        if self._matrix is None:
            B = np.zeros((self.n, self.n), dtype=np.float64)
            inner = self.inner.encode_matrix
            for m in self.members:
                B[np.ix_(m, m)] = inner
            self._matrix = B
        return self._matrix

    def chunks_of_worker(self, i: int) -> np.ndarray:
        """Global chunk ids (s+1 of them) worker-i computes: the inner
        cyclic support mapped through its cluster's member list."""
        m = self.members[self.cid[i]]
        return m[self.inner.chunks_of_worker(int(self.local_rank[i]))]

    def decode_vector(self, survivors) -> np.ndarray:
        """Length-n beta with ``g = sum_i beta_i l_i``, solved cluster
        by cluster from the survivors inside each; raises
        ``DecodingError`` naming the failing cluster's survivor count."""
        surv = np.zeros(self.n, dtype=bool)
        surv[np.asarray(sorted(survivors), dtype=np.int64)] = True
        beta = np.zeros(self.n, dtype=np.float64)
        for c, m in enumerate(self.members):
            local = np.flatnonzero(surv[m])
            try:
                beta[m] = self.inner.decode_vector(local)
            except DecodingError as err:
                raise DecodingError(
                    f"cluster {c}: {local.size} of {m.size} survivors "
                    f"cannot decode (s={self.s}): {err}"
                ) from err
        return beta

    def can_decode_mask(self, survivors: np.ndarray) -> bool:
        return all(
            self.inner.can_decode_mask(survivors[m]) for m in self.members
        )

    @property
    def normalized_load(self) -> float:
        return (self.s + 1) / self.n


def make_gradient_code(n: int, s: int, *, prefer_rep: bool = True, seed: int = 0):
    """Factory: GC-Rep when (s+1) | n (paper App. G), else general GC."""
    if s == 0:
        # degenerate: each worker owns exactly its own chunk
        return RepGradientCode(n, 0)
    if prefer_rep and n % (s + 1) == 0:
        return RepGradientCode(n, s)
    return GradientCode(n, s, seed=seed)
