"""The pretrain app's train state: the three models, the optimizer, the step."""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch

from avjepa_tpu_torch.models.encoder import Encoder
from avjepa_tpu_torch.models.predictor import Predictor
from avjepa_tpu_torch.parallel import dist, fsdp, tensor
from avjepa_tpu_torch.train.optim import make_optimizer


@dataclasses.dataclass
class TrainState:
    encoder: Encoder
    predictor: Predictor
    target_encoder: Encoder  # EMA copy of encoder, no gradients
    optimizer: torch.optim.AdamW
    step: int = 0  # global step, from which every schedule is derived
    # the ranks' layout (parallel/dist.py); None: every rank loads its own
    # samples (one process, or the data axis)
    mesh: Optional[dist.Mesh] = None

    @property
    def batch_group(self) -> Optional[dist.Group]:
        """The ranks over which a step's batch is spread (None: the world)."""
        return None if self.mesh is None else self.mesh.batch_group


def init_state(encoder: Encoder, predictor: Predictor, betas=(0.9, 0.999),
               eps: float = 1e-8, mesh: Optional[dist.Mesh] = None) -> TrainState:
    """State around the given models (already on their device); the target
    encoder starts as a copy of the encoder (reference:
    app/avjepa/train.py:224). With a ``mesh`` the three models are cut to
    this rank's tensor pieces (``tensor > 1``) and sharded over its fsdp
    ``DeviceMesh`` (``fsdp > 1``) before the optimizer is built over their
    parameters."""
    target = copy.deepcopy(encoder).requires_grad_(False)
    if mesh is not None:
        tensor.shard_models(mesh.tensor_group, encoder, predictor, target)
        if mesh.device_mesh is not None:
            fsdp.shard_models(mesh.device_mesh, encoder, predictor, target)
    return TrainState(encoder, predictor, target,
                      make_optimizer([encoder, predictor], betas, eps), mesh=mesh)
