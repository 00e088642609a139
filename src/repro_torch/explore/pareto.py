"""k-objective Pareto tools: dominance mask, non-dominated sort, crowding
distance, and an exact hypervolume indicator.

Copy of :mod:`repro.explore.pareto` (jax-free numpy) over the port's
:func:`repro_torch.core.dse_batch.pareto_mask`.

Generalizes the 2-D ``pareto_mask`` (max perf, min energy) to arbitrary
objective counts under an all-minimization convention; the 2-objective
case delegates to the existing vectorized kernel, so both agree
bit-for-bit (property-tested).

Tie semantics match the 2-D kernel: a point is dominated only by a point
that is no worse everywhere and *strictly* better somewhere, so exact
duplicates all survive.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.dse_batch import pareto_mask


def pareto_mask_k(F: np.ndarray, chunk: int = 1024) -> np.ndarray:
    """Boolean non-dominated mask of an ``(N, K)`` minimization matrix.

    ``K == 2`` delegates to the sorted/broadcast 2-D kernel; ``K >= 3``
    runs a chunked-broadcast dominance test (memory ``chunk * N`` bools —
    population-scale inputs, not million-point sweeps).
    """
    F = np.asarray(F, dtype=np.float64)
    if F.ndim != 2:
        raise ValueError(f"objective matrix must be (N, K), got {F.shape}")
    n, k = F.shape
    if n == 0:
        return np.zeros(0, dtype=bool)
    if k == 1:
        return F[:, 0] == F[:, 0].min()
    if k == 2:
        # maximize -f0 == minimize f0
        return pareto_mask(-F[:, 0], F[:, 1])
    keep = np.ones(n, dtype=bool)
    for s in range(0, n, chunk):
        block = F[s:s + chunk]                      # (B, K)
        # q dominates p: q <= p everywhere, q < p somewhere
        no_worse = (F[None, :, :] <= block[:, None, :]).all(-1)
        better = (F[None, :, :] < block[:, None, :]).any(-1)
        keep[s:s + chunk] = ~(no_worse & better).any(1)
    return keep


def nondominated_sort(F: np.ndarray) -> np.ndarray:
    """NSGA-II front ranks: 0 for the Pareto front, 1 for the front of the
    remainder, and so on.  Returns an ``(N,)`` int array."""
    F = np.asarray(F, dtype=np.float64)
    n = len(F)
    ranks = np.full(n, -1, dtype=np.int64)
    remaining = np.arange(n)
    rank = 0
    while len(remaining):
        mask = pareto_mask_k(F[remaining])
        ranks[remaining[mask]] = rank
        remaining = remaining[~mask]
        rank += 1
    return ranks


def crowding_distance(F: np.ndarray) -> np.ndarray:
    """NSGA-II crowding distance within one front (larger = lonelier;
    boundary points get ``inf``).  Ties broken stably by index."""
    F = np.asarray(F, dtype=np.float64)
    n, k = F.shape
    if n <= 2:
        return np.full(n, np.inf)
    d = np.zeros(n, dtype=np.float64)
    for j in range(k):
        order = np.argsort(F[:, j], kind="stable")
        fj = F[order, j]
        span = fj[-1] - fj[0]
        d[order[0]] = d[order[-1]] = np.inf
        if span > 0:
            d[order[1:-1]] += (fj[2:] - fj[:-2]) / span
    return d


# ---------------------------------------------------------------------------
# Hypervolume (exact, minimization, reference point r: hv of the region
# dominated by the set and dominating r)
# ---------------------------------------------------------------------------

def _hv2d(F: np.ndarray, ref: np.ndarray) -> float:
    """Closed-form 2-D hypervolume: sort by f0 and sweep."""
    order = np.lexsort((F[:, 1], F[:, 0]))
    hv = 0.0
    prev1 = ref[1]
    for p0, p1 in F[order]:
        if p1 < prev1:
            hv += (ref[0] - p0) * (prev1 - p1)
            prev1 = p1
    return hv


def _hv_recursive(F: np.ndarray, ref: np.ndarray) -> float:
    k = len(ref)
    if len(F) == 0:
        return 0.0
    if k == 1:
        return float(ref[0] - F[:, 0].min())
    if k == 2:
        return _hv2d(F, ref)
    # slice along the last objective (HSO): between consecutive levels the
    # (k-1)-D cross-section is the projection of every point at or below
    # the lower level
    order = np.argsort(F[:, -1], kind="stable")
    F = F[order]
    zs = np.unique(F[:, -1])
    hv = 0.0
    for j, z in enumerate(zs):
        z_next = zs[j + 1] if j + 1 < len(zs) else ref[-1]
        sub = F[F[:, -1] <= z, :-1]
        sub = sub[pareto_mask_k(sub)]               # shrink the recursion
        hv += (z_next - z) * _hv_recursive(sub, ref[:-1])
    return hv


def hypervolume(F: np.ndarray, ref: np.ndarray) -> float:
    """Exact hypervolume of an ``(N, K)`` minimization set w.r.t. ``ref``.

    Points not strictly better than ``ref`` in every objective contribute
    nothing (standard clipping), so a fixed reference lets fronts from
    different searches be compared on one scale.  Exact algorithms are
    exponential in ``K`` in the worst case — fine for the K <= 5 objective
    sets and population-sized fronts used here.
    """
    F = np.asarray(F, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if F.ndim != 2 or F.shape[1] != len(ref):
        raise ValueError(
            f"objective matrix {F.shape} does not match reference point "
            f"of dimension {len(ref)}")
    F = F[(F < ref[None, :]).all(axis=1)]
    if len(F) == 0:
        return 0.0
    F = np.unique(F, axis=0)
    F = F[pareto_mask_k(F)]
    return float(_hv_recursive(F, ref))


# ---------------------------------------------------------------------------
# Epsilon-dominance archive (Laumanns et al. 2002): the external archive of
# a long-horizon search bounded by a grid instead of growing without limit
# ---------------------------------------------------------------------------

class EpsilonDominanceArchive:
    """Grid-bounded external archive under epsilon-dominance
    (minimization).

    Every point maps to a grid box ``floor(F / epsilon)``.  The archive
    keeps one representative per non-dominated box: a candidate is
    rejected if any archived box dominates its box (componentwise <=,
    somewhere <); an accepted candidate evicts every archived point whose
    box it dominates; within one box the point closest to the box's lower
    corner wins (squared distance in epsilon units, ties broken stably by
    insertion order).  The number of boxes a mutually non-dominated set
    can occupy is bounded by the grid resolution, so a week-long run's
    archive holds **constant memory** regardless of evaluation count,
    while every archived point is within one grid cell of some true
    non-dominated point — hypervolume is preserved up to grid resolution
    (asserted in tests/test_epsilon_archive.py).

    Deterministic: the final contents depend only on the sequence of
    ``add`` batches, and re-inserting the archived points into a fresh
    archive reproduces it exactly (the checkpoint/resume path,
    :mod:`repro_torch.runtime.dse_checkpoint`).
    """

    def __init__(self, epsilon, n_objectives: int | None = None):
        eps = np.atleast_1d(np.asarray(epsilon, dtype=np.float64))
        if n_objectives is not None and len(eps) == 1:
            eps = np.repeat(eps, n_objectives)
        if (eps <= 0).any() or not np.isfinite(eps).all():
            raise ValueError(
                f"epsilon must be positive and finite, got {eps}")
        self.epsilon = eps
        self._genomes: np.ndarray | None = None
        self._F = np.empty((0, len(eps)), dtype=np.float64)
        self._boxes = np.empty((0, len(eps)), dtype=np.int64)

    def __len__(self) -> int:
        return len(self._F)

    @property
    def genomes(self) -> np.ndarray:
        if self._genomes is None:
            return np.empty((0, 0), dtype=np.int64)
        return self._genomes

    @property
    def objectives(self) -> np.ndarray:
        return self._F

    def _box(self, F: np.ndarray) -> np.ndarray:
        return np.floor(F / self.epsilon[None, :]).astype(np.int64)

    def add(self, genomes: np.ndarray, F: np.ndarray) -> int:
        """Offer a batch; returns how many points the archive now holds.

        The batch is folded in insertion order so resume-time replay is
        bit-identical to the original pass.
        """
        genomes = np.asarray(genomes)
        F = np.asarray(F, dtype=np.float64)
        if F.ndim != 2 or F.shape[1] != len(self.epsilon):
            raise ValueError(
                f"objective matrix {F.shape} does not match epsilon of "
                f"dimension {len(self.epsilon)}")
        if len(genomes) != len(F):
            raise ValueError(
                f"{len(genomes)} genomes vs {len(F)} objective rows")
        if self._genomes is None and len(genomes):
            self._genomes = np.empty((0,) + genomes.shape[1:],
                                     dtype=genomes.dtype)
        boxes = self._box(F)
        for i in range(len(F)):
            self._offer(genomes[i], F[i], boxes[i])
        return len(self._F)

    def _offer(self, g, f, b) -> None:
        if len(self._boxes):
            no_worse = (self._boxes <= b[None, :]).all(axis=1)
            better = (self._boxes < b[None, :]).any(axis=1)
            if (no_worse & better).any():
                return                      # box-dominated: reject
            same = (self._boxes == b[None, :]).all(axis=1)
            if same.any():
                j = int(np.nonzero(same)[0][0])   # one rep per box
                # closer to the box's lower corner wins; incumbent keeps
                # ties (stable under replay)
                corner = b * self.epsilon
                d_new = float(np.sum(((f - corner) / self.epsilon) ** 2))
                d_old = float(np.sum(
                    ((self._F[j] - corner) / self.epsilon) ** 2))
                if d_new < d_old:
                    self._genomes[j] = g
                    self._F[j] = f
                    self._boxes[j] = b
                return
            # accepted: evict every box the new box dominates
            dominated = ((b[None, :] <= self._boxes).all(axis=1)
                         & (b[None, :] < self._boxes).any(axis=1))
            if dominated.any():
                keep = ~dominated
                self._genomes = self._genomes[keep]
                self._F = self._F[keep]
                self._boxes = self._boxes[keep]
        self._genomes = np.concatenate([self._genomes, g[None]])
        self._F = np.concatenate([self._F, f[None]])
        self._boxes = np.concatenate([self._boxes, b[None]])

    def front(self) -> tuple[np.ndarray, np.ndarray]:
        """The archive's own non-dominated (genomes, objectives) — box
        representatives can still dominate each other within resolution."""
        keep = pareto_mask_k(self._F)
        return self.genomes[keep], self._F[keep]


def epsilon_from_reference(ref: np.ndarray, ideal: np.ndarray,
                           rel: float) -> np.ndarray:
    """An absolute per-objective epsilon vector from a relative grid
    resolution: ``rel`` of the (ideal, reference) span per objective —
    the convention :func:`repro_torch.explore.search.nsga2` uses to interpret a
    scalar ``archive_epsilon``."""
    if not (0.0 < rel < 1.0):
        raise ValueError(f"relative epsilon must be in (0, 1), got {rel}")
    ref = np.asarray(ref, dtype=np.float64)
    ideal = np.asarray(ideal, dtype=np.float64)
    span = np.abs(ref - ideal)
    span = np.where(span > 0, span, np.maximum(np.abs(ref), 1.0))
    return rel * span


def reference_point(F: np.ndarray, margin: float = 0.05) -> np.ndarray:
    """A reference point slightly worse than every observed objective —
    the convention used to seed a search's hypervolume history."""
    F = np.asarray(F, dtype=np.float64)
    worst = F.max(axis=0)
    span = worst - F.min(axis=0)
    pad = margin * np.where(span > 0, span, np.maximum(np.abs(worst), 1.0))
    return worst + pad
