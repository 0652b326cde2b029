"""Fixtures of the benchmark's tests: a benchmark folder with a tiny
configuration, run on the CPU.

Tests that need a CUDA device carry the ``cuda`` marker and skip, deciding
inside the test, where there is none.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from portbench import spec

DATA = Path(__file__).resolve().parent / "data"
TRAIN, EXTRACT = "pretrain.tiny", "extract.tiny"
TINY = {"pretrain.vitl16_av.b24": TRAIN, "extract.vitl16_av.b24": EXTRACT}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_root(path: Path, dtype: str = "bfloat16") -> Path:
    """A benchmark folder under ``path``: the real entries, metrics, traffic
    mixes, kernel classes and peaks, and the tiny configuration (its YAML at
    ``dtype``) with the limits of its two cells."""
    for d in ("entries", "metrics", "traffic"):
        shutil.copytree(spec.ROOT / d, path / d)
    for f in ("kernels.json", "peaks.json"):
        shutil.copy(spec.ROOT / f, path / f)
    (path / "configs").mkdir()
    (path / "limits").mkdir()
    conf = json.loads((DATA / "tiny_av.json").read_text())
    for entry in conf["yaml"].values():
        entry["meta"]["dtype"] = dtype
    (path / "configs" / "tiny_av.json").write_text(json.dumps(conf))
    limits = json.loads((DATA / "limits_tiny.json").read_text())[dtype]
    (path / "limits" / f"{TRAIN}.json").write_text(json.dumps({"limits": limits["train"]}))
    (path / "limits" / f"{EXTRACT}.json").write_text(json.dumps({"limits": limits["extract"]}))
    return path


def tiny_bench() -> dict:
    """BENCHMARK.json with its cells replaced by the two tiny ones: the tiny
    train cell reports what ViT-L's train cell reports, the tiny extract cell
    what the extract cell reports."""
    bench = spec.load_json(spec.ROOT.parent / "BENCHMARK.json")
    bench["workloads"] = [
        {"name": TRAIN, "config": "tiny_av", "traffic": "pretrain_staged", "chips": 1},
        {"name": EXTRACT, "config": "tiny_av", "traffic": "extract_staged", "chips": 1},
    ]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [TINY[w] for w in m["workloads"] if w in TINY]
    return bench


@pytest.fixture
def bf16_root(tmp_path) -> Path:
    return make_root(tmp_path / "bf16")


@pytest.fixture
def f32_root(tmp_path) -> Path:
    return make_root(tmp_path / "f32", "float32")
