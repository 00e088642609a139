"""The sweep kernel's launch plan, its reciprocal division and its cached
layer table, on the CPU.

The CUDA kernel (``csrc/sweep_kernel.cu``) runs only on a card, so what
surrounds it is held here:

* the reciprocal division: ``trunc(float(a) * rcp(float(b)))`` corrected
  once by ``a - q * b``, emulated in numpy with every float32 reciprocal
  within 1 ulp of ``1 / b`` (what ``rcp.approx.f32`` may return), equals
  ``//`` on every (dividend, divisor) pair that the ten division sites of
  a cell meet over the 1,029,600-config grid and the zoo workloads
  (VGG-16, ResNet-34, ResNet-50) at every PE type's weight bits, and at
  the edges of its domain; beyond the domain it can miss, which is why
  the kernel keeps C++ ``/`` there;
* :func:`plan` covers every (config, segment, layer) cell exactly once,
  with the kernel's block-to-tile scan and its thread-to-cell steps;
* the packed device table is kept per (layer arrays, bounds, device) and
  rebuilt when either changes.

The JAX package's numpy exact kernel is the reference for the large-GLB
configs the fast path does not take.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from repro.core import dse_batch as R
from repro.core.accelerator import design_space_soa as ref_design_space_soa
from repro.core.synthesis import synthesize_soa as ref_synthesize_soa
from repro.core.workloads import get_workload as ref_get_workload
from repro_torch.core import dse_batch as T
from repro_torch.core.accelerator import design_space_soa
from repro_torch.core.pe import PEType, pe_spec
from repro_torch.core.workloads import get_workload
from repro_torch.kernels import sweep_kernel as K

CPU = torch.device("cpu")
SOURCE = (pathlib.Path(K.__file__).parent / "csrc" / "sweep_kernel.cu"
          ).read_text()
WORKLOADS = ("vgg16", "resnet34", "resnet50")
GRID_GLB_KBS = tuple(2 ** i for i in range(2, 13))


def _constant(name: str) -> int:
    """A ``constexpr`` of the kernel source, as its source states it."""
    expr = re.search(rf"constexpr \w+ {name} = ([^;]+);", SOURCE).group(1)
    expr = re.sub(r"(\d+)u\b", r"\1", expr)
    consts = {k: _constant(k) for k in re.findall(r"\bk[A-Z]\w*", expr)}
    return int(eval(expr, {}, consts))


FIELD_MAX = _constant("kFieldMax")
GLB_HALF_MAX = _constant("kGlbHalfMax")
DIVISOR_LIMIT = _constant("kDivisorLimit")
# the largest dividend a cell on the fast path meets: k + k_fit_glb - 1
DIVIDEND_MAX = FIELD_MAX + GLB_HALF_MAX - 1


def test_planner_constants_are_the_kernels():
    assert _constant("kThreads") == K.THREADS
    assert _constant("kLayerWords") == K._LAYER_WORDS
    assert _constant("kConfigWords") == K._CONFIG_WORDS
    assert _constant("kLayerRows") == len(K.LAY_FIELDS)
    assert (FIELD_MAX, GLB_HALF_MAX, DIVISOR_LIMIT) == (2 ** 20, 2 ** 22,
                                                        2 ** 24)
    assert DIVIDEND_MAX < 5 * 2 ** 20


# ---------------------------------------------------------------------------
# the reciprocal division
# ---------------------------------------------------------------------------

def _reciprocals(b: np.ndarray) -> list[np.ndarray]:
    """Every float32 within 1 ulp of ``1 / b`` (``rcp.approx.f32``'s
    bound): the correctly rounded one and its neighbours where they lie
    that close (else the rounded one again)."""
    rn = np.float32(1.0) / b.astype(np.float32)
    exact = 1.0 / b.astype(np.float64)
    ulp = np.spacing(rn).astype(np.float64)
    out = [rn]
    for c in (np.nextafter(rn, np.float32(0)),
              np.nextafter(rn, np.float32(np.inf))):
        near = np.abs(c.astype(np.float64) - exact) <= ulp
        out.append(np.where(near, c, rn))
    return out


def _rcp_div(a: np.ndarray, b: np.ndarray, r: np.ndarray) -> np.ndarray:
    """The kernel's ``div_floor`` with reciprocal ``r`` (the kernel carries
    the integers as exact floats; the arithmetic is the same)."""
    p = a.astype(np.float32) * r                 # one float32 rounding
    q = np.trunc(p).astype(np.int64)
    rem = a - q * b
    return q + (rem >= b) - (rem < 0)


def _assert_exact(a, b) -> None:
    a = np.asarray(a, dtype=np.int64).ravel()
    b = np.asarray(b, dtype=np.int64).ravel()
    assert np.all((a >= 0) & (a <= DIVIDEND_MAX))
    assert np.all((b >= 1) & (b < DIVISOR_LIMIT))
    want = a // b
    for r in _reciprocals(b):
        assert np.array_equal(_rcp_div(a, b, r), want)


def _division_sites(cfg: dict, lay: dict) -> dict:
    """The ``(dividend, divisor)`` arrays of the ten division sites of the
    kernel's cell, in its order, over the ``(N, L)`` cells of ``cfg``
    (``(N, 1)`` columns) and ``lay`` (``(1, L)`` rows); ceilings as the
    kernel takes them, ``(a + b - 1) / b``."""
    sites = {}

    def div(name, a, b):
        a, b = np.broadcast_arrays(np.asarray(a, np.int64),
                                   np.asarray(b, np.int64))
        sites[name] = (a, b)
        return a // b

    def ceil_div(name, a, b):
        return div(name, a + b - 1, b)

    r, s, e, c, k = (lay[x] for x in ("r", "s", "e", "c", "k"))
    glb_half = cfg["glb_kb"] * 1024 // 2
    sets_fit = np.maximum(1, div("pe_rows / r", cfg["pe_rows"], r))
    c_simult = np.minimum(c, sets_fit)
    k_simult = np.maximum(1, div("sets_fit / c_simult", sets_fit,
                                 c_simult))
    fit_horz = np.minimum(e, cfg["pe_cols"])
    n_e = ceil_div("ceil(e / fit_horz)", e, fit_horz)
    ceil_div("ceil(c / c_simult)", c, c_simult)
    n_k = ceil_div("ceil(k / k_simult)", k, k_simult)
    filt_bytes_one = np.maximum(1, c * r * s * cfg["weight_bits"] // 8)
    k_fit_glb = np.maximum(1, div("glb_half / filt_bytes_one", glb_half,
                                  filt_bytes_one))
    ceil_div("ceil(k / k_fit_glb)", k, k_fit_glb)
    filt_res = np.maximum(1, div("filter_spad / max(1, s)",
                                 cfg["filter_spad"], np.maximum(1, s)))
    w_res = np.minimum(n_e, filt_res)
    ceil_div("ceil(n_k / filt_res)", n_k, filt_res)
    div("n_e / w_res", n_e, w_res)
    return sites


def _cell_fast(cfg: dict, lay: dict) -> np.ndarray:
    """The kernel's per-cell choice of the reciprocal division."""
    def in_field(x):
        return (x >= 1) & (x <= FIELD_MAX)
    lay_fast = (in_field(lay["r"]) & in_field(lay["s"]) & in_field(lay["e"])
                & in_field(lay["c"]) & in_field(lay["k"]))
    glb_half = cfg["glb_kb"] * 1024 // 2
    cfg_fast = (in_field(cfg["pe_rows"]) & in_field(cfg["pe_cols"])
                & (cfg["filter_spad"] >= 0)
                & (cfg["filter_spad"] <= FIELD_MAX)
                & (glb_half >= 0) & (glb_half <= GLB_HALF_MAX))
    fbo = np.maximum(1, lay["c"] * lay["r"] * lay["s"]
                     * cfg["weight_bits"] // 8)
    return lay_fast & cfg_fast & (fbo < DIVISOR_LIMIT)


def _zoo_layers() -> dict:
    wbs = [T._workload_batch(get_workload(w)) for w in WORKLOADS]
    return {k: np.concatenate([w.arrays[k] for w in wbs])[None, :]
            for k in wbs[0].arrays}


def _grid_cfg(glb_kbs=GRID_GLB_KBS) -> dict:
    """Every config of the streamed grid that the division sites can tell
    apart (the DRAM bandwidth enters none of them), once for each PE
    type's weight bits as a mixed-precision layer may take them."""
    soa = next(iter(design_space_soa(glb_kbs=glb_kbs, bws=(2.0,))))
    cols = {k: np.asarray(soa[k], dtype=np.int64)[:, None]
            for k in ("pe_rows", "pe_cols", "glb_kb", "filter_spad")}
    wbs = sorted({pe_spec(t).weight_bits for t in PEType}
                 | set(np.asarray(soa["weight_bits"]).tolist()))
    return {k: np.concatenate([v] * len(wbs)) for k, v in cols.items()} | {
        "weight_bits": np.repeat(np.array(wbs, dtype=np.int64),
                                 len(soa["pe_rows"]))[:, None]}


def test_grid_cells_take_the_reciprocal_division():
    cfg, lay = _grid_cfg(), _zoo_layers()
    assert len(cfg["pe_rows"]) >= 660
    assert bool(np.all(_cell_fast(cfg, lay)))


@pytest.mark.parametrize("site", range(10))
def test_reciprocal_division_exact_at_every_grid_and_zoo_pair(site):
    """One site's pairs over the 1,029,600-config grid x the zoo's 107
    layers, every PE type's weight bits among them."""
    sites = _division_sites(_grid_cfg(), _zoo_layers())
    assert len(sites) == 10
    a, b = list(sites.values())[site]
    pairs = np.unique(np.stack([a.ravel(), b.ravel()]), axis=1)
    _assert_exact(pairs[0], pairs[1])


def test_reciprocal_division_exact_at_the_edges():
    rng = np.random.default_rng(20220516)
    edges_a = np.array([0, 1, 2, 3, 2 ** 20, 2 ** 21 + 1, 2 ** 22,
                        DIVIDEND_MAX - 1, DIVIDEND_MAX])
    edges_b = np.array([1, 2, 3, 5, 7, 2 ** 12 + 1, 2 ** 23 - 1, 2 ** 23,
                        2 ** 23 + 1, DIVISOR_LIMIT - 1])
    a, b = np.meshgrid(edges_a, edges_b)
    _assert_exact(a, b)
    # every divisor up to 2^16 at the largest dividends
    b = np.arange(1, 2 ** 16 + 1)
    for top in (DIVIDEND_MAX, DIVIDEND_MAX - 1, 2 ** 22):
        _assert_exact(np.full_like(b, top), b)
    # random pairs across the domain, small divisors weighted in
    a = rng.integers(0, DIVIDEND_MAX + 1, 400_000)
    b = np.concatenate([rng.integers(1, 64, 200_000),
                        rng.integers(1, DIVISOR_LIMIT, 200_000)])
    _assert_exact(a, b)


def test_reciprocal_division_can_miss_beyond_its_domain():
    """A 64 MB GLB's half (2^25) over a one-byte filter: a reciprocal of 1
    one ulp low truncates two below the quotient, which one correction
    does not repair; such cells divide with C++ '/'."""
    a, b = np.array([2 ** 25]), np.array([1])
    got = [_rcp_div(a, b, r)[0] for r in _reciprocals(b)]
    assert 2 ** 25 - 1 in got


def test_large_glb_cells_take_integer_division():
    """GLBs above 8 MB leave the fast path (their ``glb_half`` passes
    ``kGlbHalfMax``), 8 MB and below keep it."""
    cfg = _grid_cfg(glb_kbs=(4096, 8192, 16384, 32768, 65536))
    fast = _cell_fast(cfg, _zoo_layers())
    big = cfg["glb_kb"][:, 0] > 8192
    assert bool(np.all(fast[~big])) and not bool(np.any(fast[big]))
    sites = _division_sites(cfg, _zoo_layers())
    a, b = sites["glb_half / filt_bytes_one"]
    assert int(a[big].max()) >= 2 ** 24


def test_large_glb_plain_version_matches_exact():
    """The configs the kernel divides with C++ '/' (GLB of 16 MB to
    1 GB): the kernel's plain version against the JAX package's numpy
    exact kernel."""
    soa = next(iter(ref_design_space_soa(glb_kbs=(8192, 16384, 65536,
                                                  131072),
                                         bws=(2.0, 25.6))))
    soa = {k: v[::7] for k, v in soa.items()}
    combined, bounds = R._workload_batch_many(
        tuple(ref_get_workload(w) for w in WORKLOADS))
    cfg, lay = R._make_cfg_lay(soa, ref_synthesize_soa(soa), combined)
    dcfg, dlay = T._to_device_inputs(cfg, lay, CPU, exact=False)
    got = K.sweep_aggregates(dcfg, dlay, bounds=bounds)
    for w, (s, e) in enumerate(bounds):
        sub = {k: v[:, s:e] for k, v in lay.items()}
        want = R._sweep_kernel(np, cfg, sub, outputs="aggregates")
        for k in R.AGGREGATE_OUTPUTS:
            g = got[k][w].numpy().astype(np.float64)
            x = np.asarray(want[k], dtype=np.float64)
            rel = np.max(np.abs(g - x) / np.maximum(np.abs(x), 1e-30))
            # the float32 policy's own distance on ResNet segments
            # (ROADMAP C.1) is under 2e-6
            assert rel <= (1e-6 if w == 0 else 2e-6), (w, k, rel)


# ---------------------------------------------------------------------------
# plan(n, bounds): every cell exactly once
# ---------------------------------------------------------------------------

def _block_tile(n: int, p, block: int):
    """The kernel's scan from a block to its segment and config tile."""
    b = block
    for seg, tile in enumerate(p.tiles):
        nb = -(-n // tile)
        if b < nb:
            return seg, b * tile, min(tile, n - b * tile)
        b -= nb
    return None


def _thread_cells(cfgs: int, length: int) -> list:
    """The (config, layer) cells the kernel's threads visit in a block of
    ``cfgs`` configs x ``length`` layers, by its incremental steps."""
    cells = []
    dci, dj = divmod(K.THREADS, length)
    for tid in range(K.THREADS):
        ci, j = divmod(tid, length)
        for _ in range(tid, cfgs * length, K.THREADS):
            cells.append((ci, j))
            ci, j = ci + dci, j + dj
            if j >= length:
                ci, j = ci + 1, j - length
    return cells


SEGMENTS = {
    "one_layer": tuple((j, j + 1) for j in range(16)),
    "longest": ((0, K.MAX_SEGMENT_LAYERS),),
    "ragged_w3": ((0, 16), (16, 53), (53, 107)),
}


@pytest.mark.parametrize("segs", sorted(SEGMENTS))
@pytest.mark.parametrize("n", [1, 255, 257, 32768])
def test_plan_covers_every_cell_once(n, segs):
    bounds = SEGMENTS[segs]
    p = K.plan(n, bounds)
    assert len(p.tiles) == len(bounds)
    assert p.blocks == sum(-(-n // t) for t in p.tiles)
    counts = [np.zeros((n, e - s), dtype=np.int32) for s, e in bounds]
    seen = {}
    for block in range(p.blocks):
        seg, i0, cfgs = _block_tile(n, p, block)
        s, e = bounds[seg]
        length, tile = e - s, p.tiles[seg]
        assert 1 <= cfgs <= tile <= K.MAX_TILE_CONFIGS
        assert tile * length <= max(K.TILE_CELLS, length)
        need = (K._PAIR_BYTES * tile * (length | 1)
                + 4 * (K._CONFIG_WORDS * tile + K._LAYER_WORDS * length))
        assert need <= p.smem
        if (cfgs, length) not in seen:
            cells = _thread_cells(cfgs, length)
            seen[(cfgs, length)] = (len(cells) == len(set(cells))
                                    == cfgs * length)
        assert seen[(cfgs, length)]
        counts[seg][i0:i0 + cfgs] += 1
    assert _block_tile(n, p, p.blocks) is None
    assert all(bool(np.all(c == 1)) for c in counts)


def test_plan_shapes_and_shared_memory():
    """Tiles shrink with the segment, blocks stay near TILE_CELLS cells,
    and every segment length the wrapper takes fits a block's shared
    memory (above 48 KB the C entry raises the kernel's limit)."""
    assert K.plan(32768, ((0, 16),)) == K.Plan((64,), 512, K.plan(
        32768, ((0, 16),)).smem)
    assert K.plan(32768, SEGMENTS["ragged_w3"]).tiles == (64, 27, 18)
    assert K.plan(10, ((0, 1),)).tiles == (K.MAX_TILE_CONFIGS,)
    for length in range(1, K.MAX_SEGMENT_LAYERS + 1):
        p = K.plan(1, ((0, length),))
        assert p.smem <= 227 * 1024
    assert K.plan(1, SEGMENTS["longest"]).smem > 48 * 1024


# ---------------------------------------------------------------------------
# the cached device table
# ---------------------------------------------------------------------------

def _lay(workloads=("vgg16",)):
    wbs = [T._workload_batch(get_workload(w)) for w in workloads]
    lay = {k: np.concatenate([w.arrays[k] for w in wbs])[None, :]
           for k in wbs[0].arrays}
    return T._lay_to_device(lay, CPU, exact=False)


def test_device_table_cached_and_rebuilt_on_change():
    K._TABLES.clear()
    lay, bounds = _lay(), ((0, 16),)
    first = K.device_table(lay, bounds, CPU)
    assert K.device_table(lay, bounds, CPU) is first
    assert np.array_equal(first.numpy(), K._layer_table(lay, bounds))
    # other bounds, other layer arrays, an in-place edit: a new table
    split = K.device_table(lay, ((0, 8), (8, 16)), CPU)
    assert split is not first
    assert np.array_equal(split.numpy(),
                          K._layer_table(lay, ((0, 8), (8, 16))))
    wider = dict(lay, k=lay["k"] * 2)
    assert not torch.equal(K.device_table(wider, bounds, CPU), first)
    lay["c"].add_(1)
    edited = K.device_table(lay, bounds, CPU)
    assert edited is not first
    assert np.array_equal(edited.numpy(), K._layer_table(lay, bounds))
    assert len(K._TABLES) == 4


def test_device_table_cache_is_bounded():
    K._TABLES.clear()
    lay = _lay()
    for i in range(K._MAX_TABLES + 5):
        K.device_table(dict(lay, k=lay["k"] + i), ((0, 16),), CPU)
    assert len(K._TABLES) == K._MAX_TABLES
