"""Experiment configuration without JAX.

The schema is the JAX package's own: ``ExperimentConfig`` and its section
dataclasses come from ``avjepa_tpu.config``, which imports no JAX itself.
Only its ``validate`` does (it reads the model table of the flax factory), so
this module parses the same YAML with the same section aliases and checks it
against the port's own ``VIT_SPECS``. The ``tpu:`` section is read as it is;
of its knobs, ``attn_impl`` and ``gelu`` mean something on the GPU.
"""

from __future__ import annotations

import yaml

from avjepa_tpu.config import (  # noqa: F401  (dump_config is re-exported)
    DataAugConfig,
    DataConfig,
    ExperimentConfig,
    ExtractConfig,
    LoggingConfig,
    LossConfig,
    MetaConfig,
    ModelConfig,
    OptimizationConfig,
    TpuConfig,
    _build,
    dump_config,
)
from avjepa_tpu_torch.models.factory import VIT_SPECS


def validate(cfg: ExperimentConfig) -> None:
    """``ExperimentConfig.validate`` against the port's model table, plus the
    two ``tpu:`` knobs the port reads."""
    lo = cfg.layout()
    if lo.crop_size % lo.patch_size:
        raise ValueError("crop_size % patch_size != 0")
    if lo.num_frames % lo.tubelet_size:
        raise ValueError("num_frames % tubelet != 0")
    if cfg.model.model_name not in VIT_SPECS:
        raise ValueError(
            f"unknown model {cfg.model.model_name}; options: {list(VIT_SPECS)}"
        )
    heads = VIT_SPECS[cfg.model.model_name].num_heads
    if cfg.model.pred_embed_dim % heads:
        raise ValueError(
            f"pred_embed_dim {cfg.model.pred_embed_dim} not divisible by "
            f"{cfg.model.model_name}'s {heads} heads"
        )
    if cfg.meta.dtype not in ("float32", "bfloat16", "float16"):
        raise ValueError(f"meta.dtype {cfg.meta.dtype!r}")
    if len(cfg.optimization.ema) != 2:
        raise ValueError("optimization.ema needs two values")
    if cfg.tpu.attn_impl not in ("xla", "flash"):
        raise ValueError(f"tpu.attn_impl must be 'xla' or 'flash', got {cfg.tpu.attn_impl!r}")
    if cfg.tpu.gelu not in ("tanh", "exact"):
        raise ValueError(f"tpu.gelu must be 'tanh' or 'exact', got {cfg.tpu.gelu!r}")
    if cfg.app in ("avjepa", "vjepa") and not cfg.mask:
        raise ValueError("pretraining requires >=1 mask config")
    if cfg.app == "extract":
        if cfg.extract.pooling not in ("mean", "tokens"):
            raise ValueError(
                f"extract.pooling must be 'mean' or 'tokens', got {cfg.extract.pooling!r}"
            )
        if cfg.data.num_clips != 1:
            raise ValueError("extract supports num_clips == 1 (one embedding per clip)")


def load_config(source: str | dict) -> ExperimentConfig:
    """Load from a YAML path, YAML string, or dict (the reference key schema),
    with the section aliases of ``avjepa_tpu.config.load_config``."""
    if isinstance(source, dict):
        d = source
    else:
        try:
            with open(source) as f:
                d = yaml.safe_load(f)
        except (OSError, ValueError):
            d = yaml.safe_load(source)
    if not isinstance(d, dict):
        raise ValueError("config must be a mapping")

    # the reference reads these keys from meta:, the schema files them under
    # data: and logging:
    meta_d = dict(d.get("meta") or {})
    data_d = dict(d.get("data") or {})
    logging_d = dict(d.get("logging") or {})
    if "skip_batches" in meta_d and "skip_batches" not in data_d:
        data_d["skip_batches"] = meta_d["skip_batches"]
    if "save_every_freq" in meta_d and "save_every_freq" not in logging_d:
        logging_d["save_every_freq"] = meta_d["save_every_freq"]

    cfg = ExperimentConfig(
        app=d.get("app", "avjepa"),
        data=_build(DataConfig, data_d),
        data_aug=_build(DataAugConfig, d.get("data_aug")),
        loss=_build(LossConfig, d.get("loss")),
        meta=_build(MetaConfig, meta_d),
        model=_build(ModelConfig, d.get("model")),
        optimization=_build(OptimizationConfig, dict(d.get("optimization") or {})),
        logging=_build(LoggingConfig, logging_d),
        tpu=_build(TpuConfig, d.get("tpu")),
        extract=_build(ExtractConfig, d.get("extract")),
        mask=list(d.get("mask") or []),
        raw=d,
    )
    validate(cfg)
    return cfg
