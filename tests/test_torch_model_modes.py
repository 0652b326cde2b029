"""The model modes no app of the port reaches yet, held against the JAX
package: the pos-embed resize to an off-native grid (trilinear for video,
bicubic for images, both with ``jax.image.resize``'s antialiasing), the
encoder fed video and images at another size than its layout's, and the
predictor in image mode. Weights are bridged from flax through the reference
state-dict layout; inputs are made with numpy from a seed; f32 throughout.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_cpu import one_torch_thread  # noqa: F401 (autouse)
from avjepa_tpu.layout import TokenLayout as JaxTokenLayout
from avjepa_tpu.models import pos_embed as jax_pe
from avjepa_tpu.models.encoder import Encoder as JaxEncoder
from avjepa_tpu.models.factory import init_encoder_params as jax_init_encoder_params
from avjepa_tpu.models.factory import init_predictor_params as jax_init_predictor_params
from avjepa_tpu.models.predictor import Predictor as JaxPredictor
from avjepa_tpu.utils import torch_import as jax_torch_import
from avjepa_tpu_torch.layout import TokenLayout
from avjepa_tpu_torch.models import pos_embed as pe
from avjepa_tpu_torch.models.encoder import Encoder
from avjepa_tpu_torch.models.predictor import Predictor
from avjepa_tpu_torch.utils import torch_import
from avjepa_tpu_torch.utils.checkpoint import encoder_from_jax_params, predictor_from_jax_params

# f32, one resize: the weights are computed as jax.image.resize computes them
# and summed over at most a few taps an axis, in another order
RESIZE_ATOL = 1e-6
# the port's f32 forward tolerance against the JAX package (BENCH.md
# "Parity": about 4e-6 max |diff| for the reference's encoder)
FORWARD_ATOL = 4e-6
ENC = dict(embed_dim=64, depth=2, num_heads=2, uniform_power=True, gelu="tanh")


@pytest.mark.parametrize("src,dst", [
    ((8, 14, 14), (8, 16, 16)),   # the ViT-L layout fed 256^2
    ((8, 14, 14), (4, 7, 10)),    # downsampling: antialiased
    ((3, 4, 5), (7, 2, 5)),       # up on one axis, down on one, one kept
])
def test_video_pos_embed_resize_matches_jax(src, dst):
    x = np.random.default_rng(0).normal(size=(int(np.prod(src)), 16)).astype(np.float32)
    want = jax_pe.interpolate_video_pos_embed(jnp.asarray(x), src, dst)
    got = pe.interpolate_video_pos_embed(torch.from_numpy(x), src, dst)
    assert got.shape == (int(np.prod(dst)), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=RESIZE_ATOL)


@pytest.mark.parametrize("src,dst", [((14, 14), (16, 16)), ((14, 14), (7, 9)), ((4, 4), (13, 2))])
def test_image_pos_embed_resize_matches_jax(src, dst):
    x = np.random.default_rng(1).normal(size=(int(np.prod(src)), 16)).astype(np.float32)
    want = jax_pe.interpolate_image_pos_embed(jnp.asarray(x), src, dst)
    got = pe.interpolate_image_pos_embed(torch.from_numpy(x), src, dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=RESIZE_ATOL)
    # torch's own bicubic (a = -0.75, no antialiasing) is another function
    theirs = torch.nn.functional.interpolate(
        torch.from_numpy(x).reshape(*src, 16).permute(2, 0, 1)[None], size=dst,
        mode="bicubic", align_corners=False)[0].permute(1, 2, 0).reshape(-1, 16)
    assert np.abs(theirs.numpy() - np.asarray(want)).max() > 100 * RESIZE_ATOL


def _encoders(layout: TokenLayout, seed: int):
    jlayout = JaxTokenLayout(**{f: getattr(layout, f) for f in (
        "num_frames", "crop_size", "patch_size", "tubelet_size", "audio_enabled")})
    jenc = JaxEncoder(layout=jlayout, **ENC)
    params = jax_init_encoder_params(jenc, jax.random.key(seed))
    return jenc, params, encoder_from_jax_params(Encoder(layout, **ENC), params)


def test_encoder_at_an_off_native_video_grid_matches_jax():
    """A 4 x 32^2 AV layout fed 6 x 16 x 48 (time and width upsampled,
    height downsampled): the video pos-embed is resized to the input's 3 x 1
    x 3 grid, the audio tokens keep theirs."""
    shape = (6, 16, 48)
    layout = TokenLayout(num_frames=4, crop_size=32, patch_size=16, tubelet_size=2)
    jenc, params, enc = _encoders(layout, 7)
    rng = np.random.default_rng(7)
    video = rng.normal(size=(2, *shape, 3)).astype(np.float32)
    audio = rng.normal(size=(2, 128, 192, 1)).astype(np.float32)
    want = jax.jit(jenc.apply)({"params": params}, video, audio)
    with torch.no_grad():
        got = enc(torch.from_numpy(video), torch.from_numpy(audio))
    n_video = shape[0] // 2 * (shape[1] // 16) * (shape[2] // 16)
    assert got.shape == (2, n_video + layout.num_audio_tokens, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FORWARD_ATOL)


def test_image_encoder_at_an_off_native_size_matches_jax():
    """An image-mode layout at 32^2 fed 48^2 images: bicubic resize of the
    2-D table."""
    layout = TokenLayout(num_frames=1, crop_size=32, patch_size=16, audio_enabled=False)
    jenc, params, enc = _encoders(layout, 8)
    img = np.random.default_rng(8).normal(size=(2, 48, 48, 3)).astype(np.float32)
    want = jax.jit(jenc.apply)({"params": params}, img)
    with torch.no_grad():
        got = enc(torch.from_numpy(img))
    assert got.shape == (2, 9, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FORWARD_ATOL)


def test_image_mode_predictor_matches_jax():
    """num_frames 1 (tubelet 1): the 2-D sincos table on the image tokens,
    then the audio stream; the weight bridge carries the predictor's
    parameters both ways unchanged."""
    kw = dict(num_frames=1, crop_size=48, patch_size=16, tubelet_size=1)
    layout, jlayout = TokenLayout(**kw), JaxTokenLayout(**kw)
    pkw = dict(embed_dim=64, predictor_embed_dim=32, depth=2, num_heads=2, uniform_power=True,
               num_mask_tokens=2, gelu="tanh")
    jpred = JaxPredictor(layout=jlayout, zero_init_mask_tokens=False, **pkw)
    params = jax_init_predictor_params(jpred, jax.random.key(9))
    port = predictor_from_jax_params(Predictor(layout, **pkw), params)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = torch_import.predictor_params_from_state_dict(sd)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(back),
                                                     jax.tree_util.tree_leaves(params)))
    want_back = jax_torch_import.predictor_params_from_state_dict(sd)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(back),
                                                     jax.tree_util.tree_leaves(want_back)))

    rng = np.random.default_rng(9)
    n = layout.num_tokens
    assert layout.num_video_tokens == 9
    ctx = rng.normal(size=(4, n, 64)).astype(np.float32)
    enc = rng.random((4, n)) < 0.5
    pred = ~enc & (rng.random((4, n)) < 0.7)
    midx = np.array([0, 1, 0, 1], np.int32)
    want = jax.jit(jpred.apply)({"params": params}, ctx, enc, pred, jnp.asarray(midx))
    with torch.no_grad():
        got = port(torch.from_numpy(ctx), torch.from_numpy(enc), torch.from_numpy(pred),
                   torch.from_numpy(midx).long())
    np.testing.assert_allclose(got.numpy()[pred], np.asarray(want)[pred], rtol=0,
                               atol=FORWARD_ATOL)
