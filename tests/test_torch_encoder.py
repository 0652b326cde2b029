"""The port's encoder and its parts (avjepa_tpu_torch.models) held against the
JAX package on the same weights and inputs.

Weights go from flax into the port through the reference state-dict layout
(avjepa_tpu.utils.torch_import), the bridge a user's checkpoint takes too.
Inputs are made with numpy from a seed. f32 throughout.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avjepa_tpu.layout import TokenLayout
from avjepa_tpu.models import pos_embed as jax_pe
from avjepa_tpu.models.encoder import Encoder as JaxEncoder
from avjepa_tpu.models.factory import init_encoder_params as jax_init_encoder_params
from avjepa_tpu.models.modules import Block as JaxBlock
from avjepa_tpu.models.patch_embed import AudioPatchEmbed as JaxAudioPatchEmbed
from avjepa_tpu.models.patch_embed import VideoPatchEmbed3D as JaxVideoPatchEmbed3D
from avjepa_tpu.utils.torch_import import _unstack_blocks
from avjepa_tpu_torch.models import pos_embed as pe
from avjepa_tpu_torch.models.encoder import Encoder
from avjepa_tpu_torch.models.factory import VIT_SPECS, make_encoder
from avjepa_tpu_torch.models.modules import Block
from avjepa_tpu_torch.models.patch_embed import AudioPatchEmbed, VideoPatchEmbed3D
from avjepa_tpu_torch.utils.checkpoint import encoder_from_jax_params

# 2-layer encoder at crop 64, 4 frames, with audio: 32 + 96 = 128 tokens, so
# the JAX side takes its packed kernel (K1) under attn_impl="flash"
LAYOUT = TokenLayout(num_frames=4, crop_size=64, patch_size=16, tubelet_size=2)


@pytest.mark.parametrize(
    "fn,args",
    [
        ("sincos_3d", (1024, 14, 8, True)),   # ViT-L AV, uniform_power
        ("sincos_3d", (192, 14, 8, False)),
        ("sincos_3d", (128, 4, 2, True)),
        ("sincos_2d_rect", (1024, 8, 12)),    # the 128x192 mel raster
        ("sincos_2d", (384, 14)),
    ],
)
def test_pos_embed_tables_equal_jax(fn, args):
    np.testing.assert_allclose(getattr(pe, fn)(*args), getattr(jax_pe, fn)(*args),
                               rtol=0, atol=1e-12)


def test_patch_embeds_match_jax():
    rng = np.random.default_rng(0)
    video = rng.normal(size=(2, 4, 32, 48, 3)).astype(np.float32)
    audio = rng.normal(size=(2, 32, 64, 1)).astype(np.float32)
    jv = JaxVideoPatchEmbed3D(embed_dim=32, patch_size=16, tubelet_size=2)
    ja = JaxAudioPatchEmbed(embed_dim=32, patch_size=16)
    pv = jv.init(jax.random.key(1), video)["params"]["proj"]
    pa = ja.init(jax.random.key(2), audio)["params"]["proj"]
    tv, ta = VideoPatchEmbed3D(32, 16, 2), AudioPatchEmbed(32, 16)
    pv = {"kernel": pv["kernel"], "bias": pv["bias"] + 0.5}  # nonzero biases
    pa = {"kernel": pa["kernel"], "bias": pa["bias"] - 0.5}
    with torch.no_grad():  # conv layouts: [D, C, t, kh, kw] and [D, 1, kh, kw]
        tv.weight.copy_(torch.tensor(np.asarray(pv["kernel"]).transpose(4, 3, 0, 1, 2)))
        tv.bias.copy_(torch.tensor(np.asarray(pv["bias"])))
        ta.weight.copy_(torch.tensor(np.asarray(pa["kernel"]).transpose(3, 2, 0, 1)))
        ta.bias.copy_(torch.tensor(np.asarray(pa["bias"])))
    want_v = jv.apply({"params": {"proj": pv}}, video)
    want_a = ja.apply({"params": {"proj": pa}}, audio)
    assert want_v.shape == (2, 2 * 2 * 3, 32)
    np.testing.assert_allclose(tv(torch.from_numpy(video)).detach().numpy(),
                               np.asarray(want_v), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ta(torch.from_numpy(audio)).detach().numpy(),
                               np.asarray(want_a), rtol=0, atol=1e-5)


@pytest.mark.parametrize("attn_impl,masked", [("flash", False), ("flash", True), ("xla", True)])
def test_block_matches_jax(attn_impl, masked):
    rng = np.random.default_rng(3)
    b, n, dim, heads = 2, 128, 128, 2
    x = rng.normal(size=(b, n, dim)).astype(np.float32)
    mask = rng.random((b, n)) < 0.7 if masked else None
    jb = JaxBlock(dim=dim, num_heads=heads, attn_impl=attn_impl, gelu="tanh")
    params = jb.init(jax.random.key(4), x)["params"]
    want = jb.apply({"params": params}, x, key_mask=None if mask is None else jnp.asarray(mask))
    sd = {}
    _unstack_blocks(
        {"layers": jax.tree_util.tree_map(lambda a: np.asarray(a)[None], params)}, "blocks", sd
    )
    block = Block(dim, heads, attn_impl=attn_impl, gelu="tanh")
    block.load_state_dict(
        {k.removeprefix("blocks.0."): torch.tensor(v) for k, v in sd.items()}, strict=True
    )
    with torch.no_grad():
        got = block(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("gelu,masked", [("tanh", False), ("exact", True)])
def test_encoder_matches_jax(gelu, masked):
    """The bridged 2-layer encoder. Tolerance 1e-4 max abs after the final
    norm, looser than the attention tests' 2e-5: two layers of matmuls in
    another summation order, then a LayerNorm that rescales the residual
    stream to unit variance."""
    rng = np.random.default_rng(5)
    video = rng.normal(size=(2, 4, 64, 64, 3)).astype(np.float32)
    audio = rng.normal(size=(2, 128, 192, 1)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.random((2, LAYOUT.num_tokens)) < 0.7
        mask[:, 0] = True
    kw = dict(embed_dim=128, depth=2, num_heads=2, uniform_power=True,
              attn_impl="flash", gelu=gelu)
    jenc = JaxEncoder(layout=LAYOUT, **kw)
    params = jax_init_encoder_params(jenc, jax.random.key(6))
    want = jax.jit(jenc.apply)({"params": params}, video, audio,
                               None if mask is None else jnp.asarray(mask))
    enc = encoder_from_jax_params(Encoder(LAYOUT, **kw), params)
    with torch.no_grad():
        got = enc(torch.from_numpy(video), torch.from_numpy(audio),
                  None if mask is None else torch.from_numpy(mask))
    assert got.shape == (2, LAYOUT.num_tokens, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_make_encoder_init():
    """Seeded init: same seed, same weights; clipped-normal std 0.02; zero
    biases, unit norms; block i's output projections divided by sqrt(2(i+1))."""
    lo = TokenLayout(num_frames=2, crop_size=32, patch_size=16, tubelet_size=2)
    a = make_encoder("vit_tiny", lo, seed=3)
    b = make_encoder("vit_tiny", lo, seed=3)
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    sd = a.state_dict()
    assert len(a.blocks) == VIT_SPECS["vit_tiny"].depth
    assert torch.equal(sd["norm.weight"], torch.ones(192))
    assert torch.equal(sd["blocks.3.attn.qkv.bias"], torch.zeros(3 * 192))
    assert abs(sd["blocks.0.mlp.fc1.weight"].std().item() - 0.02) < 1e-3
    ratio = sd["blocks.0.attn.proj.weight"].std() / sd["blocks.7.attn.proj.weight"].std()
    assert abs(ratio.item() - 8**0.5) < 0.1  # sqrt(2*8) / sqrt(2*1)
