"""tools/torch_run_chain.py, the port's whole user journey on media files:
its copies of the JAX chain's media code, its stage configs read by the
port, the checkpoint crossing port -> JAX -> port, and (gated, ~2 min) one
whole chain through the port's CLIs on the CPU."""

import inspect
import json
import os
import subprocess
import sys

import pytest
import torch
import yaml

from torch_cpu import load_tool, one_torch_thread  # noqa: F401 (autouse)
from avjepa_tpu_torch.config import load_config
from avjepa_tpu_torch.evals.video_classification import config_from_yaml
from avjepa_tpu_torch.train import optim, pretrain
from avjepa_tpu_torch.utils.checkpoint import save_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


chain = load_tool("torch_run_chain")


@pytest.mark.parametrize("name", ["sh", "class_av_content", "class_av_content_envelope",
                                  "make_media", "last_csv_value"])
def test_media_code_is_the_jax_chains(name):
    """The chain's media authoring, its stage runner and its CSV reader are
    tools/run_chain.py's, source for source (the clip writer's module
    aside)."""
    ours = inspect.getsource(getattr(chain, name)).replace("avjepa_tpu_torch.", "avjepa_tpu.")
    assert ours == inspect.getsource(getattr(load_tool("run_chain"), name))


def test_stage_configs_load_through_the_port(tmp_path):
    """Every stage's YAML, as the chain writes it, loads through the port's
    config (the apps) or the video eval's config; every stage after the
    pretrain reads its .pth.tar, and the control's checkpoint is absent."""
    wd = str(tmp_path)
    args = chain.parse_args(["--workdir", wd])
    cfgs = chain.stage_configs(args, wd, "train.csv", "val.csv", "train.csv")
    assert sorted(cfgs) == ["avpred", "example", "extract", "pretrain", "video_eval",
                            "video_eval_random"]
    ckpt = os.path.join(wd, "pretrain", "chain-latest.pth.tar")
    loaded = {name: yaml.safe_load(yaml.safe_dump(d)) for name, d in cfgs.items()}
    apps = {name: load_config(loaded[name]) for name in ("pretrain", "avpred", "example",
                                                         "extract")}
    assert {n: c.app for n, c in apps.items()} == {
        "pretrain": "avjepa", "avpred": "avprediction", "example": "avprediction_example",
        "extract": "extract"}
    assert os.path.join(apps["pretrain"].logging.folder, "chain-latest.pth.tar") == ckpt
    assert all(apps[n].meta.read_checkpoint == ckpt for n in ("avpred", "example", "extract"))
    assert apps["pretrain"].model.model_name == "vit_tiny"
    assert apps["pretrain"].data.datasets == ["train.csv"]
    evals = {n: config_from_yaml(loaded[n]) for n in ("video_eval", "video_eval_random")}
    assert evals["video_eval"].checkpoint == ckpt
    assert not evals["video_eval"].allow_missing_checkpoint
    assert evals["video_eval_random"].allow_missing_checkpoint
    assert not os.path.exists(evals["video_eval_random"].checkpoint)
    assert all(e.cache_features and e.num_epochs == 300 and e.num_classes == 3
               for e in evals.values())


def test_crossing_port_jax_port_is_bit_exact(tmp_path):
    """A tiny pretrain checkpoint of the port (its target encoder moved off
    the encoder, one AdamW step taken) goes through the port's Orbax writer;
    the JAX manager restores it and saves it again, in this process (the
    chain's ``jax_resave``); the port reads every encoder, predictor and
    target-encoder entry, the moments and the step back to the bit, also
    after ``--export`` to a .pth.tar."""
    from avjepa_tpu_torch.utils.checkpoint import read_checkpoint

    converter = load_tool("torch_convert_checkpoint")
    wd = str(tmp_path)
    args = chain.parse_args(["--workdir", wd, "--crop", "32", "--frames", "4"])
    d = chain.stage_configs(args, wd, "", "", "")["pretrain"]
    d["data"].update(source="synthetic", datasets=[], num_workers=0)
    h = pretrain.setup(load_config(d), torch.device("cpu"))
    h.loader.close()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in h.state.target_encoder.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 1e-3)
    params = [p for g in h.state.optimizer.param_groups for p in g["params"]]
    for p in params:
        p.grad = torch.randn(p.shape, generator=gen)
    h.state.optimizer.step()
    h.state.step = 7
    pth = os.path.join(wd, "chain-latest.pth.tar")
    save_train_state(pth, h.state, epoch=1, loss=0.0, batch_size=2, lr=0.0)

    ours, theirs = (os.path.join(wd, "crossing", side, "chain-ckpt") for side in ("port", "jax"))
    assert converter.to_orbax(pth, ours) == 7
    assert chain.jax_resave(ours, theirs) == 7
    n = chain.same_target_encoder(pth, theirs)
    assert n == len(list(h.state.target_encoder.parameters()))
    want = torch.load(pth, weights_only=True)
    back = converter.export(theirs, os.path.join(wd, "back.pth.tar"), ipe=args.ipe)
    for got in (read_checkpoint(theirs), torch.load(back, weights_only=True)):
        assert got["step"] == 7
        for key in ("encoder", "predictor", "target_encoder"):
            w = {k: v for k, v in want[key].items() if "pos_embed" not in k}
            assert sorted(got[key]) == sorted(w), key
            assert all(torch.equal(got[key][k], w[k]) for k in w), key
        moments = got["opt"]["by_name"]
        for i, (key, name) in enumerate(
                (k, n) for flag in (True, False) for k in ("encoder", "predictor")
                for n, p in want[k].items() if optim.decays(n, p) == flag):
            s = want["opt"]["state"][i]
            assert moments[key]["step"] == int(s["step"]) == 1
            assert torch.equal(moments[key]["exp_avg"][name], s["exp_avg"]), name
            assert torch.equal(moments[key]["exp_avg_sq"][name], s["exp_avg_sq"]), name


@pytest.mark.skipif(
    not os.environ.get("AVJEPA_RUN_CHAIN_CI"),
    reason="the whole chain through eight stages (~2 min on the CPU); run with "
    "AVJEPA_RUN_CHAIN_CI=1, as tests/test_end_to_end_files.py's chain",
)
def test_whole_chain_on_the_cpu(tmp_path):
    """All eight stages at the smallest geometry (6 clips, crop 32, 4
    frames, one probe epoch) through the port's CLIs on the CPU: every
    summary key of the JAX chain, the crossing bit-exact."""
    out = str(tmp_path / "chain.json")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_run_chain.py"), "--workdir",
         str(tmp_path / "chain"), "--clips", "6", "--crop", "32", "--frames", "4",
         "--eval-epochs", "1", "--device", "cpu", "--out-json", out],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    with open(out) as f:
        summary = json.load(f)["chain"]
    assert summary["roundtrip_leaves_exact"] == 150  # vit_tiny's parameters
    assert summary["extract_rows"] == 2 and summary["extract_dim"] == 192
    for key in ("pretrain_loss", "eval_train_acc", "eval_val_top1_pretrained",
                "eval_val_top1_random_encoder", "avpred_loss"):
        assert summary[key] is not None, key
    assert os.path.exists(summary["example_npz"])
    assert set(summary["timings_s"]) == {
        "media", "pretrain", "write_orbax", "jax_resave", "video_eval", "video_eval_random",
        "avpred", "example", "extract"}
