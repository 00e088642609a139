"""Import boundary and device guards of the port.

``repro_torch`` imports torch and numpy only: never jax and nothing of the
JAX package ``repro``.  Its entry points run on the card unless asked for
the CPU, and refuse CUDA on a host without it instead of falling back.
"""

import pathlib
import pkgutil
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.core.device import resolve_device

SRC = pathlib.Path(repro_torch.__file__).resolve().parent.parent


def _all_modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_every_module_is_listed():
    mods = _all_modules()
    for name in ("repro_torch.core.dse", "repro_torch.core.dse_batch",
                 "repro_torch.kernels.sweep_kernel",
                 "repro_torch.kernels._build",
                 "repro_torch.configs.qappa_workloads",
                 "repro_torch.quant.quantizers", "repro_torch.quant.policy",
                 "repro_torch.quant.qlinear",
                 "repro_torch.kernels.w8a8_matmul",
                 "repro_torch.kernels.w4a8_matmul",
                 "repro_torch.kernels.ops", "repro_torch.configs.base",
                 "repro_torch.configs.phi4_mini_3_8b",
                 "repro_torch.configs.starcoder2_7b",
                 "repro_torch.configs.deepseek_67b",
                 "repro_torch.configs.gemma3_4b",
                 "repro_torch.models.common",
                 "repro_torch.models.attention",
                 "repro_torch.models.model", "repro_torch.models.convert",
                 "repro_torch.launch.serve",
                 "repro_torch.kernels.w8a8_decode",
                 "repro_torch.kernels.flash_attention",
                 "repro_torch.serving", "repro_torch.serving.scheduler",
                 "repro_torch.serving.traffic", "repro_torch.quant.calibrate",
                 "repro_torch.configs.coexplore_presets",
                 "repro_torch.explore", "repro_torch.explore.accuracy",
                 "repro_torch.explore.objectives",
                 "repro_torch.explore.pareto", "repro_torch.explore.search",
                 "repro_torch.explore.space", "repro_torch.core.ppa_model",
                 "repro_torch.core.rtl", "repro_torch.obs",
                 "repro_torch.obs.metrics", "repro_torch.obs.trace",
                 "repro_torch.obs.report", "repro_torch.checkpoint",
                 "repro_torch.checkpoint.checkpoint",
                 "repro_torch.runtime",
                 "repro_torch.runtime.fault_tolerance",
                 "repro_torch.runtime.dse_checkpoint",
                 "repro_torch.serving.fleet_sim",
                 "repro_torch.kernels.fleet_sim",
                 "repro_torch.core.dataflow",
                 "repro_torch.configs.mamba2_130m",
                 "repro_torch.configs.zamba2_1_2b",
                 "repro_torch.models.ssm", "repro_torch.data",
                 "repro_torch.data.pipeline", "repro_torch.models.moe",
                 "repro_torch.configs.moonshot_v1_16b_a3b",
                 "repro_torch.configs.phi3_5_moe_42b_a6_6b",
                 "repro_torch.configs.llama_3_2_vision_90b",
                 "repro_torch.configs.whisper_medium",
                 "repro_torch.optim", "repro_torch.optim.adamw",
                 "repro_torch.launch.train", "repro_torch.models.tree",
                 "repro_torch.parallel",
                 "repro_torch.parallel.compression",
                 "repro_torch.core.gpu_roofline",
                 "repro_torch.core.op_analysis",
                 "repro_torch.launch.dryrun"):
        assert name in mods


def test_import_loads_neither_jax_nor_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {_all_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels import _build\n"
        "assert _build._LIBS == {}, 'a kernel was built at import'\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")).type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_cuda_refused_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for dev in ("cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(dev)


def test_run_kernel_refuses_cuda_without_a_card():
    """The aggregate route asks for the kernel on CUDA and raises on a
    host without it; it never returns the plain version's result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import numpy as np
    from repro_torch.core.accelerator import design_space_soa
    from repro_torch.core.dse_batch import (_make_cfg_lay, _run_kernel,
                                            _workload_batch)
    from repro_torch.core.synthesis import synthesize_soa
    from repro_torch.core.workloads import get_workload
    soa = next(iter(design_space_soa(glb_kbs=(64,), bws=(6.4,))))
    cfg, lay = _make_cfg_lay(soa, synthesize_soa(soa),
                             _workload_batch(get_workload("vgg16")))
    for outputs in ("aggregates", "full"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _run_kernel(cfg, lay, "cuda", outputs=outputs)
    out = _run_kernel(cfg, lay, "cpu", outputs="aggregates")
    assert all(np.isfinite(v).all() for v in out.values())


def test_nvcc_missing_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolkit is installed")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_library_names_follow_source_and_flags():
    from repro_torch.kernels import _build
    path = _build.library_path("sweep_kernel")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("sweep_kernel-") and path.suffix == ".so"
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not any("fast" in f for f in _build.NVCC_FLAGS)


@pytest.mark.parametrize("name", ["w8a8_matmul", "w4a8_matmul"])
def test_matmul_libraries_hash_their_shared_header(name, monkeypatch,
                                                   tmp_path):
    """Each matmul source has a bound C entry point, and its library name
    changes when the shared header changes (no stale build loads).  Both
    entries also take their split-k workspace and its length, the row tile
    and the split count, W8A8's also its regime; the W4A8 entry reports
    the grid it launched."""
    import shutil
    from repro_torch.kernels import _build
    fn = f"qappa_{name}"
    assert fn in _build.SIGNATURES[name]
    n_args = {"w8a8_matmul": 14, "w4a8_matmul": 14}[name]
    assert len(_build.SIGNATURES[name][fn][1]) == n_args
    before = _build.library_path(name)
    assert before.name.startswith(f"{name}-")
    src = tmp_path / "csrc"
    shutil.copytree(_build.SOURCE_DIR, src)
    monkeypatch.setattr(_build, "SOURCE_DIR", src)
    assert _build.library_path(name).name == before.name
    with open(src / "qmatmul.cuh", "a") as f:
        f.write("// edited\n")
    assert _build.library_path(name).name != before.name


@pytest.mark.parametrize("name,fn,n_args", [
    ("w8a8_decode", "qappa_w8a8_decode", 22),
    ("flash_attention", "qappa_flash_attention", 12),
    ("flash_attention_tc", "qappa_flash_attention_tc", 12),
    ("fleet_sim", "qappa_fleet_sim", 13)])
def test_attention_libraries_are_bound_and_hashed(name, fn, n_args,
                                                  monkeypatch, tmp_path):
    """Each attention source, and the fleet simulator's, has a bound C
    entry point, and its library name changes when its source changes."""
    import shutil
    from repro_torch.kernels import _build
    assert len(_build.SIGNATURES[name][fn][1]) == n_args
    assert "qappa_error_string" in _build.SIGNATURES[name]
    before = _build.library_path(name)
    assert before.name.startswith(f"{name}-")
    src = tmp_path / "csrc"
    shutil.copytree(_build.SOURCE_DIR, src)
    monkeypatch.setattr(_build, "SOURCE_DIR", src)
    assert _build.library_path(name).name == before.name
    with open(src / f"{name}.cu", "a") as f:
        f.write("// edited\n")
    assert _build.library_path(name).name != before.name


@pytest.mark.parametrize("entry", ["fit_ppa_suite", "predict", "resume_sweep",
                                   "resume_search", "run_checkpointed",
                                   "simulate_fleet", "serving_search",
                                   "serve_moe", "moe_model", "serve_vlm",
                                   "serve_audio", "vlm_model",
                                   "audio_model", "calibrate",
                                   "calibrated_search", "train",
                                   "train_ckpt"])
def test_slice_entry_points_default_to_the_card(entry, tmp_path):
    """The PPA fit, its predictions, the resumable sweep and search, the
    fleet simulator, a serving search, the MoE, vlm and audio families'
    serving and models (at full size), the tier-1 calibration, a
    calibrated search and training (also the checkpointed, restarting
    loop) run on the card unless asked for the CPU, and raise without
    one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import numpy as np
    from repro_torch.core.accelerator import AcceleratorConfig
    from repro_torch.core.dse import ExploreSpec, run
    from repro_torch.core.pe import PEType
    from repro_torch.core.ppa_model import fit_poly_model, fit_ppa_suite
    from repro_torch.core.workloads import get_workload
    from repro_torch.explore.space import space_for_workload
    from repro_torch.runtime.dse_checkpoint import resume_search, resume_sweep
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import train
    from repro_torch.models.model import Model
    from repro_torch.quant.calibrate import calibrate_model
    from repro_torch.serving.fleet_sim import simulate_fleet
    cfgs = [AcceleratorConfig(pe_rows=r, pe_cols=c) for r in (8, 12, 16)
            for c in (8, 14)]
    calls = {
        "fit_ppa_suite": lambda: fit_ppa_suite({PEType.INT16: cfgs}),
        "predict": lambda: fit_poly_model(
            cfgs, np.arange(1.0, 7.0), device="cpu").predict(cfgs, "cuda"),
        "resume_sweep": lambda: resume_sweep(
            get_workload("vgg16"), [cfgs], checkpoint_dir=str(tmp_path),
            chunk_size=4),
        "resume_search": lambda: resume_search(
            space_for_workload("vgg16"), "vgg16", 16,
            checkpoint_dir=str(tmp_path)),
        "run_checkpointed": lambda: run(ExploreSpec.single(
            "vgg16", [cfgs], chunk_size=4, checkpoint_dir=str(tmp_path))),
        "simulate_fleet": lambda: simulate_fleet(
            np.array([0.1, 0.2]), np.ones(2), "quick"),
        "serving_search": lambda: run(ExploreSpec.mixed(
            "vgg16", preset="serving-quick")),
        "serve_moe": lambda: serve("moonshot-v1-16b-a3b", quantize=True),
        "moe_model": lambda: Model(reduced(get_config(
            "phi3.5-moe-42b-a6.6b"))),
        "serve_vlm": lambda: serve("llama-3.2-vision-90b", quantize=True),
        "serve_audio": lambda: serve("whisper-medium", quantize=True),
        "vlm_model": lambda: Model(get_config("llama-3.2-vision-90b")),
        "audio_model": lambda: Model(get_config("whisper-medium")),
        "calibrate": lambda: calibrate_model("mamba2-130m",
                                             cache_dir=str(tmp_path)),
        "calibrated_search": lambda: run(ExploreSpec.mixed(
            "vgg16", preset="calibrated-quick")),
        "train": lambda: train("mamba2-130m", steps=1),
        "train_ckpt": lambda: train("mamba2-130m", steps=1,
                                    ckpt_dir=str(tmp_path),
                                    grad_compression=True),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
