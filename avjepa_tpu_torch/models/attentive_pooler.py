"""The attentive pooler and classifier: the frozen-backbone eval probe.

Counterpart of ``avjepa_tpu/models/attentive_pooler.py`` (reference:
src/models/attentive_pooler.py:21-136): learnable query tokens cross-attend
over the frozen encoder's tokens, optional extra self-attention blocks, then
a linear head. Attention is the plain masked softmax (the JAX evals' default
``attn_impl="xla"``). Module names are the reference state-dict keys
(``pooler.query_tokens``, ``pooler.cross_attention_block.*`` or
``pooler.cross_attention.*``, ``pooler.blocks.{i}.*``, ``linear``), so
``classifier_params_to_state_dict`` loads flax weights strictly.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from avjepa_tpu_torch.models.modules import Block, CrossAttention, CrossAttentionBlock, linear


class AttentivePooler(nn.Module):
    """[B, N, D] tokens -> [B, num_queries, D] in ``dtype``."""

    def __init__(self, embed_dim: int = 768, num_queries: int = 1, num_heads: int = 12,
                 mlp_ratio: float = 4.0, depth: int = 1, qkv_bias: bool = True,
                 complete_block: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.query_tokens = nn.Parameter(torch.zeros(1, num_queries, embed_dim))
        if complete_block:
            self.cross_attention_block = CrossAttentionBlock(embed_dim, num_heads, mlp_ratio,
                                                             qkv_bias, dtype)
        else:
            self.cross_attention = CrossAttention(embed_dim, num_heads, qkv_bias, dtype)
        self.complete_block = complete_block
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, dtype=dtype)
            for _ in range(depth - 1))

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None):
        q = self.query_tokens.expand(x.shape[0], -1, -1).to(self.dtype)
        if self.complete_block:
            q = self.cross_attention_block(q, x, key_mask)
        else:
            q = self.cross_attention(q, x, key_mask)
        for blk in self.blocks:
            q = blk(q)
        return q


class AttentiveClassifier(nn.Module):
    """[B, N, D] tokens -> [B, num_classes] logits in ``dtype``."""

    def __init__(self, embed_dim: int = 768, num_heads: int = 12, mlp_ratio: float = 4.0,
                 depth: int = 1, qkv_bias: bool = True, num_classes: int = 1000,
                 complete_block: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pooler = AttentivePooler(embed_dim, 1, num_heads, mlp_ratio, depth, qkv_bias,
                                      complete_block, dtype)
        self.linear = nn.Linear(embed_dim, num_classes)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None):
        return linear(self.linear, self.pooler(x, key_mask)[:, 0])
