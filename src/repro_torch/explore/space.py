"""Mixed-precision co-exploration search space (QUIDAM/QADAM direction).

Copy of :mod:`repro.explore.space` (jax-free numpy); genome digests come
from the port's copy of ``confighash``, byte-identical to the reference's.

A *genome* is one point of the joint (accelerator config x per-layer
execution precision) space, encoded as a packed ``uint16`` row:

* ``genome[:N_HW_GENES]`` — factor-level indices of the hardware half
  (PE type, array dims, spad scale, GLB capacity, DRAM bandwidth), the
  same factors :func:`repro_torch.core.accelerator.design_space` enumerates;
* ``genome[N_HW_GENES:]`` — one PE-type index per workload layer
  (canonical ``tuple(PEType)`` order), the layer's execution mode on the
  precision-scalable datapath.

Everything here is vectorized over genome *populations* — decode produces
the struct-of-arrays form that :func:`repro_torch.core.dse_batch._sweep_mixed`
consumes directly, and the hardware half of every genome is digested by
:mod:`repro_torch.core.confighash`, so repeated hardware (the common case
in an evolutionary search) hits the existing synthesis caches.  Genome digests
(hardware + assignment words through the same counter hash) key the
search's evaluation memo.

All randomness flows through an explicit ``numpy.random.Generator``; random
draws are made in data-independent order so equal seeds give bit-identical
populations regardless of genome contents.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.core.accelerator import (DEFAULT_ARRAY_DIMS, DEFAULT_BWS,
                                    DEFAULT_GLB_KBS, DEFAULT_SPAD_SCALES,
                                    soa_from_fields, spad_capacities)
from repro_torch.core.confighash import digest_keys, digest_words
from repro_torch.core.pe import PEType, mode_compat_matrix

# genome layout: hardware factor levels, then one mode gene per layer
N_HW_GENES = 5
GENE_NAMES = ("pe_type", "array_dim", "spad_scale", "glb_kb", "dram_bw")

_TYPES = tuple(PEType)
_TYPE_IDX = {t: i for i, t in enumerate(_TYPES)}


@functools.lru_cache(maxsize=1)
def _mode_choice_table() -> tuple[np.ndarray, np.ndarray]:
    """``(counts, choices)``: for hardware type ``h``, the executable mode
    indices are ``choices[h, :counts[h]]`` (padded with the hw index)."""
    compat = mode_compat_matrix()
    t = len(_TYPES)
    counts = compat.sum(axis=1).astype(np.int64)
    choices = np.full((t, t), -1, dtype=np.int64)
    for h in range(t):
        ms = np.nonzero(compat[h])[0]
        choices[h, :len(ms)] = ms
        choices[h, len(ms):] = h          # padding never selected
    return counts, choices


@dataclasses.dataclass(frozen=True)
class CoExploreSpace:
    """Factor grid of the joint design space for one workload shape.

    The hardware factors default to the paper's Sec. 3.3 sweep; the
    per-layer mode alphabet is always the full ``PEType`` set, constrained
    at sample/repair time to modes the hardware can execute.
    """

    n_layers: int
    pe_types: tuple[PEType, ...] = _TYPES
    array_dims: tuple[tuple[int, int], ...] = DEFAULT_ARRAY_DIMS
    spad_scales: tuple[float, ...] = DEFAULT_SPAD_SCALES
    glb_kbs: tuple[int, ...] = DEFAULT_GLB_KBS
    bws: tuple[float, ...] = DEFAULT_BWS

    def __post_init__(self):
        if self.n_layers < 1:
            raise ValueError("n_layers must be >= 1")
        object.__setattr__(self, "pe_types",
                           tuple(PEType(t) for t in self.pe_types))

    # ---- layout ------------------------------------------------------------
    @property
    def genome_width(self) -> int:
        return N_HW_GENES + self.n_layers

    @property
    def hw_levels(self) -> tuple[int, ...]:
        """Number of levels of each hardware gene."""
        return (len(self.pe_types), len(self.array_dims),
                len(self.spad_scales), len(self.glb_kbs), len(self.bws))

    def size(self) -> float:
        """Cardinality of the joint space (float: overflows int64 fast)."""
        counts, _ = _mode_choice_table()
        hw = float(np.prod(self.hw_levels))
        per_type = [float(counts[_TYPE_IDX[t]]) ** self.n_layers
                    for t in self.pe_types]
        return hw / len(self.pe_types) * sum(per_type)

    # ---- factor tables (absolute values per level) -------------------------
    def _tables(self) -> dict[str, np.ndarray]:
        # one build per space instance (frozen dataclass, so the factors
        # never change); level -> value mapping shared with the grid
        # sweeps via accelerator.spad_capacities + DEFAULT_* constants
        tbl = getattr(self, "_tbl", None)
        if tbl is None:
            spads = [spad_capacities(s) for s in self.spad_scales]
            tbl = {
                "type_idx": np.array([_TYPE_IDX[t] for t in self.pe_types],
                                     dtype=np.int64),
                "rows": np.array([d[0] for d in self.array_dims],
                                 dtype=np.int64),
                "cols": np.array([d[1] for d in self.array_dims],
                                 dtype=np.int64),
                "ifmap": np.array([s[0] for s in spads], dtype=np.int64),
                "filt": np.array([s[1] for s in spads], dtype=np.int64),
                "psum": np.array([s[2] for s in spads], dtype=np.int64),
                "glb": np.array(self.glb_kbs, dtype=np.int64),
                "bw": np.array(self.bws, dtype=np.float64),
            }
            object.__setattr__(self, "_tbl", tbl)
        return tbl

    # ---- encode / decode ---------------------------------------------------
    def decode(self, genomes: np.ndarray, *, skip_validation: bool = False
               ) -> tuple[dict[str, np.ndarray], np.ndarray]:
        """Genome matrix -> (hardware SoA, ``(N, L)`` mode assignment).

        The SoA is exactly what
        :func:`repro_torch.core.dse_batch._sweep_mixed` and the synthesis
        caches consume; invalid genomes raise.
        ``skip_validation`` is for hot loops whose rows were already
        validated at the batch boundary (e.g. the search evaluator).
        """
        g = self.validate(genomes, raise_on_invalid=not skip_validation)
        t = self._tables()
        it, id_ = g[:, 0], g[:, 1]
        is_, ig, ib = g[:, 2], g[:, 3], g[:, 4]
        soa = soa_from_fields(
            pe_type_idx=t["type_idx"][it],
            pe_rows=t["rows"][id_], pe_cols=t["cols"][id_],
            ifmap_spad=t["ifmap"][is_], filter_spad=t["filt"][is_],
            psum_spad=t["psum"][is_], glb_kb=t["glb"][ig],
            dram_bw_gbps=t["bw"][ib],
            clock_cap=np.full(len(g), np.inf))
        assign = g[:, N_HW_GENES:].astype(np.int64)
        return soa, assign

    def validate(self, genomes: np.ndarray,
                 raise_on_invalid: bool = False) -> np.ndarray:
        """Check level ranges + hardware/mode compatibility.

        Returns the validated ``(N, W)`` int64 matrix, or raises with a
        count of offending genomes when ``raise_on_invalid``; otherwise
        use :meth:`valid_mask`.
        """
        g = np.asarray(genomes, dtype=np.int64)
        if g.ndim != 2 or g.shape[1] != self.genome_width:
            raise ValueError(
                f"genome matrix shape {g.shape} != "
                f"(N, {self.genome_width}) for {self.n_layers} layers")
        if raise_on_invalid:
            bad = ~self.valid_mask(g)
            if bad.any():
                raise ValueError(
                    f"{int(bad.sum())} invalid genome(s): hardware levels "
                    f"out of range or modes unsupported by their hardware")
        return g

    def valid_mask(self, genomes: np.ndarray) -> np.ndarray:
        """Per-genome validity: levels in range and modes executable."""
        g = np.asarray(genomes, dtype=np.int64)
        levels = np.array(self.hw_levels, dtype=np.int64)
        ok = ((g[:, :N_HW_GENES] >= 0).all(axis=1)
              & (g[:, :N_HW_GENES] < levels[None, :]).all(axis=1))
        modes = g[:, N_HW_GENES:]
        in_range = (modes >= 0).all(axis=1) & (modes < len(_TYPES)).all(axis=1)
        ok &= in_range
        if ok.any():
            hw = np.where(ok, g[:, 0], 0)
            hw_abs = self._tables()["type_idx"][hw]
            compat = mode_compat_matrix()[hw_abs[:, None],
                                          np.where(in_range[:, None],
                                                   modes, 0)]
            ok &= compat.all(axis=1)
        return ok

    # ---- sampling / variation (seed-threaded, data-independent draws) ------
    def random_population(self, n: int,
                          rng: np.random.Generator) -> np.ndarray:
        """``n`` uniform-random valid genomes."""
        levels = self.hw_levels
        g = np.empty((n, self.genome_width), dtype=np.int64)
        for j, lv in enumerate(levels):
            g[:, j] = rng.integers(0, lv, size=n)
        counts, choices = _mode_choice_table()
        hw_abs = self._tables()["type_idx"][g[:, 0]]
        u = rng.random((n, self.n_layers))
        pick = np.floor(u * counts[hw_abs][:, None]).astype(np.int64)
        g[:, N_HW_GENES:] = choices[hw_abs[:, None], pick]
        return g

    def repair(self, genomes: np.ndarray) -> np.ndarray:
        """Clamp layer modes unsupported by their hardware to the
        hardware's own type (deterministic, in place on a copy)."""
        g = np.asarray(genomes, dtype=np.int64).copy()
        hw_abs = self._tables()["type_idx"][g[:, 0]]
        modes = g[:, N_HW_GENES:]
        ok = mode_compat_matrix()[hw_abs[:, None], modes]
        g[:, N_HW_GENES:] = np.where(ok, modes, hw_abs[:, None])
        return g

    def mutate(self, genomes: np.ndarray, rng: np.random.Generator,
               rate: float = 0.08) -> np.ndarray:
        """Per-gene resampling mutation followed by compatibility repair.

        Every random draw happens unconditionally (mask applied after), so
        the RNG stream — and hence the whole search trajectory — depends
        only on the seed and population shapes, not on genome values.
        """
        g = np.asarray(genomes, dtype=np.int64).copy()
        n = len(g)
        flip = rng.random(g.shape) < rate
        levels = self.hw_levels
        for j, lv in enumerate(levels):
            fresh = rng.integers(0, lv, size=n)
            g[:, j] = np.where(flip[:, j], fresh, g[:, j])
        counts, choices = _mode_choice_table()
        hw_abs = self._tables()["type_idx"][g[:, 0]]
        u = rng.random((n, self.n_layers))
        pick = np.floor(u * counts[hw_abs][:, None]).astype(np.int64)
        fresh_modes = choices[hw_abs[:, None], pick]
        lay = g[:, N_HW_GENES:]
        g[:, N_HW_GENES:] = np.where(flip[:, N_HW_GENES:], fresh_modes, lay)
        return self.repair(g)

    def crossover(self, a: np.ndarray, b: np.ndarray,
                  rng: np.random.Generator) -> np.ndarray:
        """Uniform crossover of two parent matrices + repair."""
        a = np.asarray(a, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        take_a = rng.random(a.shape) < 0.5
        return self.repair(np.where(take_a, a, b))

    # ---- identity ----------------------------------------------------------
    def _digest_salt(self) -> tuple[int, ...]:
        """Extra words folded into every genome digest, so genomes of
        structurally different spaces (layer counts, workload boundaries)
        can never alias."""
        return (self.n_layers,)

    def genome_digests(self, genomes: np.ndarray):
        """128-bit counter-hash digests of whole genomes (hardware levels
        + assignment), via the same primitive that keys the synthesis
        caches (:mod:`repro_torch.core.confighash`)."""
        g = self.validate(genomes)
        words = [g[:, j].astype(np.uint32)
                 for j in range(self.genome_width)]
        # fold the space's structure in so equal prefixes of different
        # spaces cannot alias
        for salt in self._digest_salt():
            words.append(np.full(len(g), salt, dtype=np.uint32))
        return digest_words(words)

    def genome_keys(self, genomes: np.ndarray) -> list[bytes]:
        """16-byte memo keys, one per genome."""
        return digest_keys(self.genome_digests(genomes))

    # ---- storage (uint16 pack / unpack) ------------------------------------
    def pack_genomes(self, genomes: np.ndarray) -> np.ndarray:
        """Validated genome matrix -> compact ``uint16`` form.

        Every gene is a small factor level or mode index (all < 2**16 by
        construction), so the packed matrix is a lossless 4x-smaller
        serialization — archives, golden files, and npz checkpoints store
        this form.  Round-trips bit-identically through
        :meth:`unpack_genomes` (property-tested).
        """
        g = self.validate(genomes, raise_on_invalid=True)
        return g.astype(np.uint16)

    def unpack_genomes(self, packed: np.ndarray) -> np.ndarray:
        """Inverse of :meth:`pack_genomes`; validates on the way out so a
        corrupted archive fails loudly instead of decoding garbage."""
        g = np.asarray(packed, dtype=np.uint16).astype(np.int64)
        return self.validate(g, raise_on_invalid=True)


@dataclasses.dataclass(frozen=True)
class CoExploreManySpace(CoExploreSpace):
    """Joint design space for W workloads sharing one accelerator.

    The QUIDAM co-exploration setting: one hardware config serves every
    workload, but each workload gets its own per-layer execution-precision
    assignment.  The genome stays a single flat uint row —

    * ``genome[:N_HW_GENES]`` — the shared hardware half (unchanged);
    * ``genome[N_HW_GENES:]`` — the W workloads' ragged per-layer mode
      segments packed back to back, workload ``w`` occupying columns
      ``[N_HW_GENES + offset_w, N_HW_GENES + offset_w + layer_counts[w])``.

    Because mode validity depends only on the shared hardware (never on
    which workload a layer belongs to), every inherited operator —
    sampling, mutation, crossover, repair, validation, digests —
    works on the packed layout unchanged; :meth:`split_assign` recovers
    the per-workload ``(N, L_w)`` matrices that
    :func:`repro_torch.core.dse_batch._sweep_mixed_many` consumes.
    """

    layer_counts: tuple[int, ...] = ()
    workload_names: tuple[str, ...] = ()

    def __post_init__(self):
        counts = tuple(int(c) for c in self.layer_counts)
        if not counts or any(c < 1 for c in counts):
            raise ValueError(
                f"layer_counts must be a non-empty tuple of positive "
                f"ints, got {self.layer_counts!r}")
        object.__setattr__(self, "layer_counts", counts)
        if self.n_layers != sum(counts):
            raise ValueError(
                f"n_layers={self.n_layers} != sum(layer_counts)="
                f"{sum(counts)}")
        if self.workload_names and len(self.workload_names) != len(counts):
            raise ValueError(
                f"{len(self.workload_names)} workload names for "
                f"{len(counts)} layer-count segments")
        super().__post_init__()

    @property
    def n_workloads(self) -> int:
        return len(self.layer_counts)

    @property
    def segment_bounds(self) -> tuple[tuple[int, int], ...]:
        """``(start, end)`` column bounds of each workload's mode segment
        within the ``(N, sum L_w)`` assignment matrix."""
        bounds = []
        start = 0
        for c in self.layer_counts:
            bounds.append((start, start + c))
            start += c
        return tuple(bounds)

    def split_assign(self, assign: np.ndarray) -> list[np.ndarray]:
        """Split the packed ``(N, sum L_w)`` assignment into per-workload
        ``(N, L_w)`` views (no copy)."""
        a = np.asarray(assign)
        if a.ndim != 2 or a.shape[1] != self.n_layers:
            raise ValueError(
                f"assignment shape {a.shape} != (N, {self.n_layers})")
        return [a[:, s:e] for s, e in self.segment_bounds]

    def _digest_salt(self) -> tuple[int, ...]:
        # fold every segment boundary in: (3, 5) and (5, 3) share a total
        # layer count but are different spaces
        return (self.n_layers, self.n_workloads, *self.layer_counts)


def space_for_workload(workload, **overrides) -> CoExploreSpace:
    """A :class:`CoExploreSpace` sized to ``workload``'s layer count."""
    from repro_torch.core.workloads import Workload, get_workload
    wl = get_workload(workload) if isinstance(workload, str) else workload
    assert isinstance(wl, Workload)
    return CoExploreSpace(n_layers=len(wl.layers), **overrides)


def space_for_workloads(workloads, **overrides) -> CoExploreManySpace:
    """A :class:`CoExploreManySpace` sized to a workload suite (names may
    be strings from :data:`repro_torch.core.workloads.WORKLOADS`)."""
    from repro_torch.core.workloads import Workload, get_workload
    wls = [get_workload(w) if isinstance(w, str) else w for w in workloads]
    if not wls:
        raise ValueError("space_for_workloads needs at least one workload")
    assert all(isinstance(w, Workload) for w in wls)
    counts = tuple(len(w.layers) for w in wls)
    return CoExploreManySpace(n_layers=sum(counts), layer_counts=counts,
                              workload_names=tuple(w.name for w in wls),
                              **overrides)
