"""The port stands alone: no JAX, nothing of the JAX package, and the
card by default.  Also: ``chip_smoke.py`` refuses to run without a card,
and refuses to run outside the repository."""

import ast
import importlib
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from repro_torch import device as tdev
from repro_torch.core import schedule as tsch
from repro_torch.serve import Bucket, ScanService

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
SMOKE = ROOT / "chip_smoke.py"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT + [SMOKE],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    bad = [m for m in _imports(path)
           if m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro"]
    assert not bad, f"{path.name} imports {bad}"
    assert "import jax" not in path.read_text()


def test_resolve_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tdev.resolve()
    with pytest.raises(RuntimeError):
        tdev.resolve("cuda")
    assert tdev.resolve("cpu") == torch.device("cpu")


# the benchmark CLIs and examples: each ``main`` runs on the card unless
# given ``--device cpu``
CLI_MAINS = tuple(f"repro_torch.benchmarks.{m}" for m in (
    "round_counts", "plan_table", "autotune_bench", "exscan_table1",
    "moe_dispatch", "ssm_context_parallel", "exec_bench", "serve_bench",
    "run")) + tuple(f"repro_torch.examples.{m}" for m in (
        "quickstart", "context_parallel_ssm", "moe_dispatch_exscan",
        "train_smoke"))
# the harness's in-process entries, ``run(csv_rows)`` as in the JAX
# package, likewise run on the card unless given ``device="cpu"``
RUN_FNS = tuple(f"repro_torch.benchmarks.{m}:run" for m in (
    "round_counts", "plan_table", "exscan_table1", "moe_dispatch",
    "ssm_context_parallel"))


@pytest.mark.parametrize("entry",
                         ("executor_and_service",) + CLI_MAINS + RUN_FNS)
def test_entry_points_default_to_the_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if entry == "executor_and_service":
        with pytest.raises(RuntimeError):
            tsch.StackedExecutor()
        with pytest.raises(RuntimeError):
            ScanService(4, [Bucket()])
        return
    if ":" in entry:
        module, fn = entry.split(":")
        rows = []
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(importlib.import_module(module), fn)(rows)
        assert rows == []  # raised before a row was made
        return
    main = importlib.import_module(entry).main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])


def _run_smoke(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, even where there is one
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(ROOT, SMOKE)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA card" in proc.stderr


def test_chip_smoke_fails_alone(tmp_path):
    # the script looks for the port before it looks for a card, so this
    # fails for the missing package even on a machine without a card
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, alone)
    proc = _run_smoke(tmp_path, alone)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "No module named 'repro_torch'" in proc.stderr
