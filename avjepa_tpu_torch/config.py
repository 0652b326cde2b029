"""Typed experiment configuration, without JAX.

The port's copy of ``avjepa_tpu/config.py``: the same YAML schema (the
reference's keys, plus the JAX package's ``tpu:`` section), the same
dataclasses, defaults and section aliases, validated against the port's own
``VIT_SPECS``. Of the ``tpu:`` knobs, ``attn_impl``, ``gelu``, ``remat``,
``mask_type``, ``compact_context``, ``compact_predictor``,
``sticky_mask_buckets`` and ``light_metrics`` mean the same on the GPU; of
the mesh knobs, ``mesh_data`` is the data axis over the process group (one
process per GPU, ``parallel/dist.py::make_mesh``: -1 takes what is left),
``mesh_fsdp`` shards the models over that many ranks
(``parallel/fsdp.py``, FSDP2), and ``mesh_tensor`` splits each block's
heads and MLP width over that many ranks, which load one batch
(``parallel/tensor.py``, Megatron's layout).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import yaml

from avjepa_tpu_torch.layout import TokenLayout


@dataclasses.dataclass
class DataConfig:
    dataset_type: str = "audiovideodataset"
    datasets: Sequence[str] = ()
    batch_size: int = 24
    num_clips: int = 1
    num_frames: int = 16
    tubelet_size: int = 2
    sampling_rate: int = 4
    crop_size: int = 224
    patch_size: int = 16
    num_workers: int = 4
    pin_mem: bool = True  # accepted for reference-config compatibility
    decode_one_clip: bool = True  # dead in the reference too; accepted
    filter_short_videos: bool = False
    filter_long_videos: int = int(1e9)  # bytes (reference filters by file size)
    clip_duration: Optional[float] = None
    datasets_weights: Optional[Sequence[float]] = None
    # fast-forward the data stream by N batches at startup
    # (reference: app/avjepa/train.py:356-366)
    skip_batches: int = 0
    # the reference reads mask_type from the data section; takes precedence
    # over tpu.mask_type
    mask_type: Optional[str] = None
    val_datasets: Optional[Sequence[str]] = None
    log_resource_utilization: bool = False
    # 'synthetic' generates deterministic fake AV clips (no media files)
    source: str = "files"


@dataclasses.dataclass
class DataAugConfig:
    auto_augment: bool = False
    motion_shift: bool = False
    random_resize_aspect_ratio: Sequence[float] = (0.75, 1.35)
    random_resize_scale: Sequence[float] = (0.3, 1.0)
    reprob: float = 0.0
    horizontal_flip: bool = True


@dataclasses.dataclass
class LossConfig:
    loss_exp: float = 1.0
    reg_coeff: float = 0.0


@dataclasses.dataclass
class MetaConfig:
    seed: int = 234
    dtype: str = "bfloat16"
    load_checkpoint: bool = False
    read_checkpoint: Optional[str] = None
    eval_freq: int = 100  # read by no reference code path; accepted
    use_sdpa: bool = True  # accepted; attention is tpu.attn_impl


@dataclasses.dataclass
class ModelConfig:
    model_name: str = "vit_base"
    pred_depth: int = 6
    pred_embed_dim: int = 384
    uniform_power: bool = False
    use_mask_tokens: bool = True
    zero_init_mask_tokens: bool = True


@dataclasses.dataclass
class OptimizationConfig:
    ipe: int = 300
    ipe_scale: float = 1.25
    clip_grad: Optional[float] = 10.0
    weight_decay: float = 0.04
    final_weight_decay: float = 0.4
    epochs: int = 300
    warmup: float = 40
    start_lr: float = 2e-4
    lr: float = 6.25e-4
    final_lr: float = 1e-6
    ema: Sequence[float] = (0.998, 1.0)
    betas: Sequence[float] = (0.9, 0.999)
    eps: float = 1e-8


@dataclasses.dataclass
class LoggingConfig:
    folder: str = "./logs"
    write_tag: str = "jepa"
    checkpoint_freq: int = 1
    save_every_freq: int = -1
    log_freq: int = 10


@dataclasses.dataclass
class TpuConfig:
    """The JAX package's extension section, under its own name so that the
    same YAML files load in both packages."""

    mesh_data: int = -1
    mesh_fsdp: int = 1
    mesh_tensor: int = 1
    # recompute each transformer block in the backward pass
    remat: bool = False
    attn_impl: str = "xla"  # 'xla' | 'flash'
    mask_type: str = "multiblock3d"
    # run the context encoder only on kept tokens (bucketed to 128)
    compact_context: bool = True
    # run the predictor blocks only on enc∪pred tokens (bucketed to 128)
    compact_predictor: bool = True
    gelu: str = "tanh"  # 'tanh' | 'exact'
    # K buckets only ratchet upward (fewer distinct shapes, more padding)
    sticky_mask_buckets: bool = False
    # diagnostic reductions only on log_freq steps
    light_metrics: bool = True


@dataclasses.dataclass
class ExtractConfig:
    output: Optional[str] = None  # default: <logging.folder>/<write_tag>-features
    pooling: str = "mean"  # 'mean' -> one [D] vector per clip; 'tokens' -> [N, D]
    use_target_encoder: bool = True
    layer_norm: bool = True
    limit: Optional[int] = None
    allow_random: bool = False
    chunk_rows: int = 2048


@dataclasses.dataclass
class ExperimentConfig:
    app: str = "avjepa"
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    data_aug: DataAugConfig = dataclasses.field(default_factory=DataAugConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    meta: MetaConfig = dataclasses.field(default_factory=MetaConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optimization: OptimizationConfig = dataclasses.field(default_factory=OptimizationConfig)
    logging: LoggingConfig = dataclasses.field(default_factory=LoggingConfig)
    tpu: TpuConfig = dataclasses.field(default_factory=TpuConfig)
    extract: ExtractConfig = dataclasses.field(default_factory=ExtractConfig)
    mask: Sequence[dict] = dataclasses.field(default_factory=list)
    raw: dict = dataclasses.field(default_factory=dict, repr=False)

    def layout(self, audio: Optional[bool] = None) -> TokenLayout:
        if audio is None:
            audio = self.data.dataset_type.lower() in ("audiovideodataset", "avdataset")
        return TokenLayout(
            num_frames=self.data.num_frames,
            crop_size=self.data.crop_size,
            patch_size=self.data.patch_size,
            tubelet_size=self.data.tubelet_size,
            audio_enabled=audio,
        )


def validate(cfg: ExperimentConfig) -> None:
    """The JAX package's ``ExperimentConfig.validate`` against the port's
    model table, plus the ``tpu:`` knobs the port reads."""
    from avjepa_tpu_torch.models.factory import VIT_SPECS

    lo = cfg.layout()
    if lo.crop_size % lo.patch_size:
        raise ValueError("crop_size % patch_size != 0")
    if lo.num_frames % lo.tubelet_size:
        raise ValueError("num_frames % tubelet != 0")
    if cfg.model.model_name not in VIT_SPECS:
        raise ValueError(f"unknown model {cfg.model.model_name}; options: {list(VIT_SPECS)}")
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


def _build(cls, d: Optional[dict]):
    """``cls`` from the keys of ``d`` that are its fields (others ignored)."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in (d or {}).items() if k in names})


def load_config(source: str | dict) -> ExperimentConfig:
    """Load from a YAML path, YAML string, or dict (the reference key schema),
    with the JAX package's section aliases."""
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
        optimization=_build(OptimizationConfig, d.get("optimization")),
        logging=_build(LoggingConfig, logging_d),
        tpu=_build(TpuConfig, d.get("tpu")),
        extract=_build(ExtractConfig, d.get("extract")),
        mask=list(d.get("mask") or []),
        raw=d,
    )
    validate(cfg)
    return cfg


def dump_config(cfg: ExperimentConfig, path: str) -> None:
    """Dump the effective config next to the logs (reference: app/main.py:51-53)."""
    with open(path, "w") as f:
        yaml.safe_dump(cfg.raw or dataclasses.asdict(cfg), f)
