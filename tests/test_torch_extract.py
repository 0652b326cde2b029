"""The port's serving slice (avjepa_tpu_torch's extract app) as a whole.

(a) the app end to end on the CPU (asked for with device="cpu"), with what
tests/test_extract.py asserts of the JAX app; (b) the port's app against the
JAX app on the same weights and rows; (c) the port imports neither JAX nor
the JAX package; and the host-side pieces it re-implements (sampler,
feature LN, checkpoint reading) against the JAX ones.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_cpu import one_torch_thread  # noqa: F401 (autouse)
from avjepa_tpu.config import load_config as jax_load_config
from avjepa_tpu.data.loader import ShardedSampler as JaxShardedSampler
from avjepa_tpu.models.factory import init_encoder_params as jax_init_encoder_params
from avjepa_tpu.models.factory import make_encoder as jax_make_encoder
from avjepa_tpu.registry import app_main as jax_app_main
from avjepa_tpu.train.step import feature_layer_norm as jax_feature_layer_norm
from avjepa_tpu.utils.torch_import import encoder_params_to_state_dict
from avjepa_tpu_torch.data.loader import BatchLoader, ShardedSampler
from avjepa_tpu_torch.registry import app_main
from avjepa_tpu_torch.train.step import feature_layer_norm
from avjepa_tpu_torch.utils.checkpoint import load_encoder_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(folder, crop=32, **over):
    d = {
        "app": "extract",
        "meta": {"seed": 11, "dtype": "float32"},
        "data": {
            "source": "synthetic",
            "dataset_type": "audiovideodataset",
            "batch_size": 4,
            "num_frames": 4,
            "tubelet_size": 2,
            "crop_size": crop,
            "patch_size": 16,
            "num_workers": 2,
        },
        "model": {"model_name": "vit_tiny"},
        "extract": {"pooling": "mean", "allow_random": True, "limit": 10},
        "logging": {"folder": str(folder), "write_tag": "x"},
    }
    for k, v in over.items():
        d[k] = {**d.get(k, {}), **v}
    return d


def test_extract_synthetic_mean(tmp_path):
    out = app_main("extract", _cfg(tmp_path), device="cpu")
    # limit=10 at batch 4 -> 3 batches (12 rows, 2 wrap-padded duplicates),
    # exactly 10 unique rows written
    assert out["rows_written"] == 10 and out["rows_total"] == 10
    z = np.load(os.path.join(out["output"], "features_r0.npz"))
    assert z["embeddings"].shape == (10, 192)  # vit_tiny embed_dim
    assert sorted(z["indices"].tolist()) == list(range(10))
    assert np.all(np.isfinite(z["embeddings"])) and z["embeddings"].std() > 0
    idx_csv = open(os.path.join(out["output"], "index_r0.csv")).read()
    assert idx_csv.count("\n") == 11  # header + 10 rows
    summary = json.load(open(os.path.join(out["output"], "summary_r0.json")))
    assert summary["pooling"] == "mean" and summary["dim"] == 192
    assert summary["rows_missing"] == 0 and summary["files"] == ["features_r0.npz"]
    assert not os.path.exists(os.path.join(out["output"], "missing_r0.csv"))


def test_extract_tokens_chunks(tmp_path):
    d = _cfg(tmp_path, extract={"pooling": "tokens", "limit": 6, "chunk_rows": 4})
    out = app_main("extract", d, device="cpu")
    files = sorted(f for f in os.listdir(out["output"]) if f.startswith("tokens_r0_"))
    assert out["rows_written"] == 6 and out["chunked"] and len(files) == 2  # 4 + 2
    shapes = [np.load(os.path.join(out["output"], f))["embeddings"].shape for f in files]
    assert shapes == [(4, 8 + 96, 192), (2, 8 + 96, 192)]


def test_extract_matches_jax_app(tmp_path):
    """The whole slice against the JAX app: the JAX encoder is initialised as
    the JAX app initialises it, saved as a reference-layout .pth.tar, and read
    by the port's app; both apps embed the same synthetic rows. At crop 64
    the sequence is 32 + 96 = 128 tokens, so with attn_impl flash both sides
    take the classic kernel path (vit_tiny's 3 heads do not pack): JAX's
    Pallas kernel in interpret mode, the port's plain version on the CPU.
    Tolerance 1e-4 max abs: 12 layers of f32 matmuls summed in other orders,
    then the feature LN and the mean."""
    d = _cfg(tmp_path / "jax", crop=64, tpu={"attn_impl": "flash"},
             extract={"limit": 5}, data={"batch_size": 1})
    cfg = jax_load_config(d)
    jenc = jax_make_encoder(cfg.model.model_name, cfg.layout(),
                            uniform_power=cfg.model.uniform_power, dtype=jnp.float32,
                            attn_impl=cfg.tpu.attn_impl, gelu=cfg.tpu.gelu)
    params = jax_init_encoder_params(jenc, jax.random.key(cfg.meta.seed))
    ckpt = tmp_path / "enc.pth.tar"
    sd = encoder_params_to_state_dict(params)
    torch.save({"target_encoder": {k: torch.tensor(v) for k, v in sd.items()}}, ckpt)

    want = jax_app_main("extract", d)
    d_port = _cfg(tmp_path / "port", crop=64, tpu={"attn_impl": "flash"},
                  extract={"limit": 5, "allow_random": False},
                  meta={"read_checkpoint": str(ckpt)})
    got = app_main("extract", d_port, device="cpu")
    zj = np.load(os.path.join(want["output"], "features_r0.npz"))
    zp = np.load(os.path.join(got["output"], "features_r0.npz"))
    np.testing.assert_array_equal(zp["indices"], zj["indices"])
    assert zp["embeddings"].shape == (5, 192)
    np.testing.assert_allclose(zp["embeddings"], zj["embeddings"], rtol=0, atol=1e-4)


def test_package_imports_no_jax():
    """Every module of avjepa_tpu_torch imports (the avprediction slice's
    among them: the LayerNorm kernels, probes, app, eval and eval CLI; and
    the classification evals', with the attentive classifier and
    RandAugment), then chip_smoke, then the port's tools
    tools/torch_parity_bf16.py and tools/torch_run_chain.py; none of them
    pulls in JAX (or flax, optax, orbax) or any module of the JAX package
    avjepa_tpu, directly or through what it imports."""
    code = (
        "import importlib, importlib.util, pkgutil, sys, avjepa_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(avjepa_tpu_torch.__path__, "
        "'avjepa_tpu_torch.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "def bad():\n"
        "    return sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax') or m == 'avjepa_tpu' "
        "or m.startswith('avjepa_tpu.'))\n"
        "new = {'avjepa_tpu_torch.' + m for m in ('ops.layer_norm', "
        "'models.prediction_probes', 'train.avprediction', 'evals', 'evals.av_prediction', "
        "'app.eval_main', 'models.attentive_pooler', 'evals.video_classification', "
        "'evals.image_classification', 'data.randaugment', 'parallel', 'parallel.dist', "
        "'parallel.fsdp', 'app.main_distributed', 'utils.monitoring', "
        "'data.video_transforms')}\n"
        "assert new <= set(mods), new - set(mods)\n"
        "assert len(mods) >= 36 and not bad(), (len(mods), bad())\n"
        "import chip_smoke\n"
        "assert not bad(), bad()\n"
        "for tool in ('torch_parity_bf16', 'torch_run_chain'):\n"
        "    spec = importlib.util.spec_from_file_location(tool, f'tools/{tool}.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "    assert not bad(), (tool, bad())\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize(
    "n,batch,shards,shuffle,drop_last",
    [(10, 4, 1, False, False), (10, 32, 1, False, False), (23, 4, 3, True, False),
     (23, 4, 3, True, True), (7, 2, 2, False, True)],
)
def test_sampler_matches_jax(n, batch, shards, shuffle, drop_last):
    for shard in range(shards):
        kw = dict(dataset_len=n, batch_size=batch, shuffle=shuffle, seed=5,
                  num_shards=shards, shard_index=shard, drop_last=drop_last)
        ours, ref = ShardedSampler(**kw), JaxShardedSampler(**kw)
        ours.set_epoch(2)
        ref.set_epoch(2)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))


class _Flaky:
    """12 samples; index 5 never decodes."""

    def __len__(self):
        return 12

    def __getitem__(self, i):
        if i == 5:
            raise OSError("undecodable")
        return np.full((2, 4, 4, 3), i, np.float32), None, i


class _Broken(_Flaky):
    def __getitem__(self, i):
        raise OSError("undecodable")


def test_batch_loader_resamples_and_surfaces_errors():
    loader = BatchLoader(_Flaky(), ShardedSampler(12, 4, shuffle=False), num_workers=8)
    try:
        batches = list(loader)
        labels = np.concatenate([b[2] for b in batches])
        # the failed row is replaced by a resampled one, which reports its own index
        assert len(batches) == 3 and 5 not in labels and batches[0][1] is None
        assert all(np.all(v[j] == lab) for v, _, ls in batches for j, lab in enumerate(ls))
        it = iter(loader)  # abandoning an iterator stops its producer
        next(it)
        it.close()
    finally:
        loader.close()
    broken = BatchLoader(_Broken(), ShardedSampler(4, 4, shuffle=False), num_workers=2)
    try:
        with pytest.raises(RuntimeError, match="persistent decode failure"):
            list(broken)
    finally:
        broken.close()


def test_feature_layer_norm_matches_jax():
    h = np.random.default_rng(0).normal(2.0, 3.0, size=(3, 7, 64)).astype(np.float32)
    np.testing.assert_allclose(feature_layer_norm(torch.from_numpy(h)).numpy(),
                               np.asarray(jax_feature_layer_norm(jnp.asarray(h))),
                               rtol=0, atol=2e-6)


def test_unported_apps_and_orbax_dirs_are_refused(tmp_path):
    """A JAX pretrain Orbax directory (the JAX manager's ``JepaState``
    fields, vit_tiny) is read: its target encoder equals the JAX params
    through the state-dict mapping, to the bit; a directory without a
    committed step raises; the app without a checkpoint is refused."""
    from avjepa_tpu.utils.checkpoint import CheckpointManager as JaxManager

    layout = jax_load_config(_cfg(tmp_path)).layout()
    params = jax.device_get(jax_init_encoder_params(jax_make_encoder("vit_tiny", layout),
                                                    jax.random.key(3)))
    ckpt = str(tmp_path / "x-ckpt")
    JaxManager(ckpt).save(4, {"target_params": params, "step": np.asarray(4, np.int32)})
    got = load_encoder_checkpoint(ckpt)
    want = encoder_params_to_state_dict(params)
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k].numpy(), want[k]) for k in want)
    with pytest.raises(FileNotFoundError, match="committed"):
        load_encoder_checkpoint(str(tmp_path))
    d = _cfg(tmp_path, extract={"allow_random": False})
    with pytest.raises(ValueError, match="read_checkpoint"):
        app_main("extract", d, device="cpu")
