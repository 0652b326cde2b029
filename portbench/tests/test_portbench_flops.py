"""The FLOP and byte arithmetic against counts made by hand at tiny shapes."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import flops
from portbench.reference.vit import ModelSpec

TINY = ModelSpec(embed_dim=8, depth=2, num_heads=2, mlp_ratio=4.0, pred_embed_dim=4,
                 pred_depth=1, pred_num_heads=2, patch_size=2, tubelet_size=2, num_frames=2,
                 crop_size=4, spec_height=2, spec_width=4, uniform_power=True, gelu="tanh",
                 num_mask_tokens=2)


def test_tiny_spec_tokens():
    # 1 x 2 x 2 video tokens, 1 x 2 spectrogram tokens
    assert (TINY.num_video_tokens, TINY.num_audio_tokens, TINY.num_tokens) == (4, 2, 6)


def test_tower_flops_by_hand():
    # a block over 3 tokens of width 8, batch 2: qkv 2*3*8*24, proj 2*3*8*8,
    # fc1 2*3*8*32, fc2 2*3*32*8 a sample; attention 4*3*3*8
    gemm = 2 * 3 * 8 * 24 + 2 * 3 * 8 * 8 + 2 * 3 * 8 * 32 + 2 * 3 * 32 * 8
    attn = 4 * 3 * 3 * 8
    assert flops.tower_flops(2, 3, 8, 1, 4.0) == 2 * (gemm + attn)
    assert flops.tower_flops(2, 3, 8, 5, 4.0) == 5 * 2 * (gemm + attn)


def test_embed_and_encode_flops_by_hand():
    # video patch 2 x 2 x 2 x 3 = 24 inputs, spectrogram patch 2 x 2 = 4
    assert flops.embed_flops(TINY, 1, 4, 2) == 2 * 8 * (4 * 24 + 2 * 4)
    want = flops.embed_flops(TINY, 3, 4, 2) + flops.tower_flops(3, 6, 8, 2, 4.0)
    assert flops.encode_flops(TINY, 3) == want


def test_train_flops_by_hand():
    m = flops.MaskCounts(ctx=3, ctx_video=2, pred=2)
    b = 2
    target = flops.encode_flops(TINY, b)
    context = 2 * flops.embed_flops(TINY, b, 2, 1) + 3 * flops.tower_flops(b, 3, 8, 2, 4.0)
    pred = 3 * (2 * b * 3 * 8 * 4 + flops.tower_flops(b, 5, 4, 1, 4.0) + 2 * b * 2 * 4 * 8)
    assert flops.train_flops(TINY, b, [m]) == target + context + pred
    assert flops.train_flops(TINY, b, [m, m]) == target + 2 * (context + pred)


def test_mask_counts():
    enc = np.array([[1, 1, 0, 0, 1, 0], [0, 1, 1, 0, 0, 1]], bool)
    pred = np.array([[0, 0, 1, 1, 0, 0], [1, 0, 0, 1, 0, 0]], bool)
    assert flops.mask_counts(enc, pred, 4) == flops.MaskCounts(3, 2, 2)
    with pytest.raises(ValueError):
        flops.mask_counts(enc, pred[::-1] | np.eye(2, 6, dtype=bool), 4)


def test_attention_call_work_by_hand():
    fwd = flops.AttnCall(batch=2, tokens=5, heads=3, head_dim=4, backward=False)
    bwd = flops.AttnCall(batch=2, tokens=5, heads=3, head_dim=4, backward=True)
    assert fwd.ops() == 4 * 3 * 4 * 2 * 25
    assert bwd.ops() == 10 * 3 * 4 * 2 * 25
    rows = 2 * 5 * 3 * 4
    assert fwd.bytes() == 4 * rows * 2 + 2 * 3 * 5 * 4
    assert bwd.bytes() == 8 * rows * 2 + 2 * (2 * 3 * 5 * 4)
    # a bytes-bound call and an operations-bound one
    assert fwd.least_s(1e12, 1e9) == fwd.bytes() / 1e9
    assert fwd.least_s(1.0, 1e30) == fwd.ops()


def test_train_attention_calls_and_launches():
    m0 = flops.MaskCounts(ctx=3, ctx_video=2, pred=2)
    m1 = flops.MaskCounts(ctx=1, ctx_video=1, pred=4)
    calls = flops.train_attention(TINY, 2, [m0, m1])
    fwd = [c for c in calls if not c.backward]
    bwd = [c for c in calls if c.backward]
    # the target's 2 layers; each config's 2 context layers and 1 predictor layer
    assert len(fwd) == 2 + 2 * (2 + 1) and len(bwd) == 2 * (2 + 1)
    assert sorted(c.tokens for c in fwd) == [1, 1, 3, 3, 5, 5, 6, 6]
    assert {c.head_dim for c in calls} == {4, 2}
    # one launch a call, or the predictor's configs batched as one
    assert flops.launches_match(calls, TINY, 2, 8, 6)
    assert flops.launches_match(calls, TINY, 2, 7, 5)
    assert not flops.launches_match(calls, TINY, 2, 8, 5)
    assert not flops.launches_match(calls, TINY, 2, 0, 0)
    assert len(flops.encode_attention(TINY, 2)) == 2
