"""What the runner finds by name: ``BENCHMARK.json``'s entries and the files
that each name stands for, under the benchmark's folder (``ROOT``):

- ``configs/<config>.json``: a model configuration (its widths, the YAML the
  program loads, the optimizer settings, its source and cuts);
- ``traffic/<traffic>.json``: a traffic mix, the parameters that the entry
  it names reads;
- ``entries/<entry>.py``: the loop a traffic mix drives, by the mix's
  ``entry``: a class ``Cell(conf, traffic, seed, device)`` with ``batch``,
  ``k`` (distinct batches) and ``failed``; ``setup()`` (build the program,
  make the inputs from the seed, warm every shape); ``call(i) -> clips`` (the
  window's call on batch ``i``); ``flops(i)`` and ``attention(i)`` (its model
  FLOPs and attention calls, ``flops.py``); ``launches_match(i, fwd, bwd)``;
  ``release()`` (free the program); ``numbers()`` (the numbers compared,
  ``check.py``); ``readings(seed, program, control)`` (``calibrate.py``);
- ``limits/<workload>.json``: the limits of the numbers that decide a cell's
  ``correct``;
- ``metrics/<metric>.py``: a metric's reader, ``read(window) -> float |
  None`` (None where the window holds nothing for it). A metric whose name
  has no file of its own takes its family's, the name cut at its last dot
  (``mfu.train`` reads ``metrics/mfu.py``); ``workloads`` in
  ``BENCHMARK.json`` says where each reports;
- ``kernels.json``: the kernel-name prefixes of each class of device work;
- ``peaks.json``: the peak rates of each device kind.

A file added under a new name is found without an edit here.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, root: Path = ROOT) -> dict:
    return load_json(root / "configs" / f"{name}.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    return load_json(root / "traffic" / f"{name}.json")


def limits(workload_name: str, root: Path = ROOT) -> dict:
    return load_json(root / "limits" / f"{workload_name}.json")["limits"]


def kernel_classes(root: Path = ROOT) -> dict:
    return load_json(root / "kernels.json")["classes"]


def peaks(device_kind: str, root: Path = ROOT) -> dict | None:
    """The peaks of the first entry whose ``match`` is in the device's name."""
    for entry in load_json(root / "peaks.json")["devices"]:
        if entry["match"] in device_kind:
            return entry
    return None


def _module(path: Path, prefix: str):
    name = prefix + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def entry_module(name: str, root: Path = ROOT):
    return _module(root / "entries" / f"{name}.py", "portbench_entry_")


def entry(name: str, root: Path = ROOT):
    """The ``Cell`` class of the entry ``name``."""
    return entry_module(name, root).Cell


def metric_reader(name: str, root: Path = ROOT):
    """The reader of the metric ``name``, or of its family."""
    family = name
    while not (root / "metrics" / f"{family}.py").exists() and "." in family:
        family = family.rsplit(".", 1)[0]
    return _module(root / "metrics" / f"{family}.py", "portbench_metric_").read


def reports(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones, or with
    ``trace`` the per-layer ones, that list the cell or list no cells; a
    per-layer metric without a list goes where the metric it moves goes."""
    def listed(m, e2e_names):
        if "workloads" in m:
            return cell in m["workloads"]
        return m.get("moves") in e2e_names if trace else True

    e2e = [m for m in bench["end_to_end"] if listed(m, ())]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if listed(m, names)]
