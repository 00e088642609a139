"""Fixtures of the benchmark's tests: the checkout on ``sys.path``, and a
copy of the benchmark with a configuration, a traffic mix and a cell
made up for the tests, added as new files only."""

from __future__ import annotations

import json
import pathlib
import shutil
import sys

import pytest
import torch

# tiny CPU shapes: one thread each, so that a loaded host does not stall
# the tests in its thread pool
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: a dense decoder small enough for the CPU, in the published keys
TINY_CONFIG = {
    "source": "made up for the tests", "hidden_size": 64,
    "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "intermediate_size": 128, "vocab_size": 256,
    "hidden_act": "silu", "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
    "quant": "w4a8_pow2",
}
TINY_TRAFFIC = {
    "lengths": {"kind": "lognormal", "median": 24, "sigma": 0.5, "min": 8,
                "max": 48, "cycle": 8},
    "check_requests": 4,
}
#: the limits of the made-up cell (set for its sizes, not the cells')
TINY_LIMITS = {"limits": {"top_gap": 0.5, "logit_err": 0.2}}


def add_cell(root: pathlib.Path, name: str, config: dict, traffic: dict,
             limits: dict) -> str:
    """Add a configuration, a mix and a cell to the benchmark copy at
    ``root``: three new files and entries appended to BENCHMARK.json.
    Returns the cell's name."""
    bench_dir = root / "portbench"
    (bench_dir / "configs" / f"{name}.json").write_text(json.dumps(config))
    (bench_dir / "traffic" / f"{name}-mix.json").write_text(
        json.dumps(traffic))
    cell = f"{name}.{name}-mix"
    (bench_dir / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": name, "source": "made up",
                             "file": f"portbench/configs/{name}.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": cell, "config": name,
                               "traffic": f"{name}-mix", "chips": 1,
                               "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell


@pytest.fixture
def bench_copy(tmp_path) -> pathlib.Path:
    """A copy of BENCHMARK.json and ``portbench/`` (without its tests)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    return tmp_path


@pytest.fixture
def tiny_cell(bench_copy):
    """``(root, cell name)`` of the made-up W4A8 cell."""
    return bench_copy, add_cell(bench_copy, "tiny", TINY_CONFIG,
                                TINY_TRAFFIC, TINY_LIMITS)


@pytest.fixture
def cuda_device():
    """The card, or a skip where this host has none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
