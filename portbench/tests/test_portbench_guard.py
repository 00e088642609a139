"""The harness's own limits: no result without a card or without the
program, and the module guard comparing whole top-level names."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT
from portbench.harness import guard

ARGS = ["--workload", "phi4-w4a8.prefill-long", "--seed", "4294967311",
        "--seconds", "1", "--trace", "0"]


def test_forbidden_modules_compare_whole_top_level_names():
    assert guard.forbidden_modules(["repro_torch", "repro_torch.models",
                                    "jaxtyping", "flaxen", "torch"]) == []
    assert guard.forbidden_modules(["repro", "torch"]) == ["repro"]
    assert guard.forbidden_modules(["repro.models.model"]) == ["repro"]
    assert guard.forbidden_modules(["jax.numpy", "jaxlib.xla_client",
                                    "flax.linen"]) == ["flax", "jax",
                                                       "jaxlib"]


def test_the_harness_imports_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "import portbench.harness.main, portbench.reference.dense; "
            "import repro_torch.models.model; "
            "from portbench.harness import guard; "
            "print(guard.forbidden_modules())"
            % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_require_cards_refuses_without_enough(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(guard.NoDevice):
        guard.require_cards(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(guard.NoDevice):
        guard.require_cards(4)


def _run(root, env=None):
    return subprocess.run(
        [sys.executable, str(root / "portbench" / "run.py"), *ARGS],
        cwd=root, capture_output=True, text=True, timeout=300,
        env={**os.environ, **(env or {})})


def _printed_a_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                return True
        except ValueError:
            pass
    return False


def test_no_card_no_result():
    out = _run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert not _printed_a_result(out.stdout)
    assert "card" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert not _printed_a_result(out.stdout)


def test_caches_pinned_inside_the_checkout(tmp_path, monkeypatch):
    for var in guard.CACHE_VARS:
        monkeypatch.delenv(var, raising=False)
    guard.pin_caches(tmp_path)
    for var in guard.CACHE_VARS:
        path = os.environ[var]
        assert path.startswith(str(tmp_path / ".portbench_cache"))
        assert os.path.isdir(path)
