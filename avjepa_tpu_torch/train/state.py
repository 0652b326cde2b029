"""The pretrain app's train state: the three models, the optimizer, the step."""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from avjepa_tpu_torch.models.encoder import Encoder
from avjepa_tpu_torch.models.predictor import Predictor
from avjepa_tpu_torch.parallel.fsdp import shard_models
from avjepa_tpu_torch.train.optim import make_optimizer


@dataclasses.dataclass
class TrainState:
    encoder: Encoder
    predictor: Predictor
    target_encoder: Encoder  # EMA copy of encoder, no gradients
    optimizer: torch.optim.AdamW
    step: int = 0  # global step, from which every schedule is derived


def init_state(encoder: Encoder, predictor: Predictor, betas=(0.9, 0.999),
               eps: float = 1e-8, mesh: Optional[DeviceMesh] = None) -> TrainState:
    """State around the given models (already on their device); the target
    encoder starts as a copy of the encoder (reference:
    app/avjepa/train.py:224). With a ``mesh`` (the fsdp axis) the three
    models are sharded over it before the optimizer is built over
    the sharded parameters."""
    target = copy.deepcopy(encoder).requires_grad_(False)
    if mesh is not None:
        shard_models(mesh, encoder, predictor, target)
    return TrainState(encoder, predictor, target,
                      make_optimizer([encoder, predictor], betas, eps))
