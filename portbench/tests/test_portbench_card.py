"""The traced path on a CUDA device, at the tiny size: every metric of both
tiny cells is read from a real profile, and no share passes 100%.

    python3 -m pytest portbench/tests -m cuda -q

Skips where there is no CUDA device (decided inside the test)."""

from __future__ import annotations

import pytest
import torch

from portbench import run, spec
from portbench.tests.conftest import EXTRACT, TRAIN, make_root, tiny_bench


@pytest.mark.cuda
def test_tiny_cells_traced_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    root = make_root(tmp_path / "root")
    bench = tiny_bench()
    dev = torch.device("cuda", 0)
    for name in (TRAIN, EXTRACT):
        w = spec.workload(bench, name)
        r = run.run_cell(bench, w, 2**31 + 5, 1.0, True, dev, 0.0, root)
        assert r["correct"], r["checks"]
        want = {m["name"] for m in spec.reports(bench, name, True)}
        got = set(r["metrics"])
        # the tiny model's attention runs the plain path where its heads do not
        # pack (vit_tiny's 3), so its roofline may stay silent
        assert want - got <= {"attn_roofline_pct.train", "attn_roofline_pct.extract"}, got
        for k, m in r["metrics"].items():
            if m["unit"] == "%":
                assert 0 <= m["value"] <= 100, (k, m)
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert r["breakdown"]["device_ops"]
