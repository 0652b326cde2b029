"""The LayerNorm backward kernel's schedule (K6, the register path of
avjepa_tpu_torch/csrc/layer_norm.cu), emulated in torch and held against the
port's plain version ``layer_norm_bwd_ref``, which is the kernel's contract
(and is itself held against the JAX package in tests/test_torch_layer_norm.py).

The emulation follows the kernel. A row of C columns is spread over L lanes
in chunks of L x VEC columns (VEC = 16 bytes of the input type), L = 32, 16
or 8, whichever pads the row least (``width_class``). A lane's sums run over
each chunk's VEC values, then over its chunks in order, then as a butterfly
over the L lanes (mean, then the square sum, then sum(g) and sum(g * xhat)).
Tiles of 8 warps x 32 / L rows go to ``grid`` persistent blocks: block b takes
tiles b, b + grid, ... in order, and the lane group at row slot s of each tile
adds dy * xhat and dy into its own sums, row after row. A block adds its
slots' sums in slot order into one partial row; the final kernel's thread row
r adds blocks r, r + 32, ... in order, then the 32 row sums in order. Rows past
R are zeros and add exact zeros.
Inputs are made with numpy from a seed. Tolerances: f32 1e-5 of max|plain|
(sums in other orders; on the card the compiler may also fuse a product and
a sum into one FMA, and rsqrtf is not rounded as torch.rsqrt is); bf16
chip_smoke.LN_REL_TOL and LN_PARAM_REL_TOL, the kernel's tolerances on the
card.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from avjepa_tpu_torch.ops import layer_norm as ln

WARPS = 8       # warps of a persistent block (BWD_WARPS)
RED_ROWS = 32   # thread rows of the final sum (RED_ROWS)
SMS = 132       # the H100's SM count: the kernel's grid is min(SMs, tiles)
F32 = torch.float32
F32_REL_TOL = 1e-5


def _vec(dtype) -> int:
    return 16 // torch.empty((), dtype=dtype).element_size()


def _chunks_for(c: int, vec: int) -> int:
    """Chunks of 32 lanes a row needs, rounded up to an instantiated count."""
    need = -(-c // (32 * vec))
    return need if need <= 6 else 8 if need <= 8 else 10 if need <= 10 else 12


def width_class(c: int, vec: int) -> tuple[int, int]:
    """(lanes a row, chunks a lane): 16 or 8 lanes (at most 3 chunks) where
    they pad the row less than 32 lanes do."""
    lanes, n = 32, _chunks_for(c, vec)
    pad = n * 32 * vec - c
    for l in (16, 8):
        m = -(-c // (l * vec))
        if m <= 3 and m * l * vec - c < pad:
            lanes, n, pad = l, m, m * l * vec - c
    return lanes, n


def schedule(r: int, lanes: int, grid: int):
    """(tile rows, tiles, tiles a block) of R rows over ``grid`` blocks."""
    tile_rows = WARPS * (32 // lanes)
    tiles = -(-r // tile_rows)
    return tile_rows, tiles, -(-tiles // grid) if tiles else 0


def _butterfly(v: torch.Tensor) -> torch.Tensor:
    """The xor-shuffle sum over the last dim (L lanes); every lane ends with
    the same value, lane 0's is returned."""
    lanes = v.shape[-1]
    o = lanes // 2
    while o:
        v = v + v[..., torch.arange(lanes) ^ o]
        o //= 2
    return v[..., 0]


def _lane_sum(t: torch.Tensor) -> torch.Tensor:
    """[R, N, L, VEC] -> [R, L]: over each chunk's VEC values, then over the
    chunks in order."""
    s = torch.zeros(t.shape[0], t.shape[2], dtype=F32)
    for k in range(t.shape[1]):
        p = torch.zeros_like(s)
        for j in range(t.shape[3]):
            p = p + t[:, k, :, j]
        s = s + p
    return s


def emulate_bwd(x, gamma, dy, eps=1e-6, grid=None):
    """K6's register path on [R, C] rows: (dx in x's type, dgamma, dbeta)."""
    r, c = x.shape
    vec = _vec(x.dtype)
    lanes, n = width_class(c, vec)
    width = n * lanes * vec
    tile_rows, tiles, iters = schedule(r, lanes, grid or SMS)
    grid = grid or max(min(SMS, tiles), 1)

    def pad(t):
        out = torch.zeros(t.shape[:-1] + (width,), dtype=F32)
        out[..., :c] = t.float()
        return out

    xs, ds, g = pad(x), pad(dy), pad(gamma)
    inside = torch.arange(width) < c
    lane = (r, n, lanes, vec)
    mean = _butterfly(_lane_sum(xs.view(lane))) / c
    d = torch.where(inside, xs - mean[:, None], torch.zeros((), dtype=F32))
    rstd = torch.rsqrt(_butterfly(_lane_sum((d * d).view(lane))) / c + eps)
    xhat = (xs - mean[:, None]) * rstd[:, None]
    gg = ds * g
    a = _butterfly(_lane_sum(gg.view(lane))) / c
    bt = _butterfly(_lane_sum((gg * xhat).view(lane))) / c
    dx = (rstd[:, None] * (gg - a[:, None] - xhat * bt[:, None]))[:, :c].to(x.dtype)

    # rows -> (tile, slot), tiles -> (iteration, block); zeros past R
    sums = []
    for contrib in (ds * xhat, ds):
        rows = torch.zeros((iters * grid * tile_rows, width), dtype=F32)
        rows[:r] = contrib
        rows = rows.view(iters, grid, tile_rows, width)
        acc = torch.zeros((grid, tile_rows, width), dtype=F32)
        for i in range(iters):
            acc = acc + rows[i]
        part = torch.zeros((grid, width), dtype=F32)
        for slot in range(tile_rows):
            part = part + acc[:, slot]
        total = torch.zeros(width, dtype=F32)
        for row in range(RED_ROWS):
            s = torch.zeros(width, dtype=F32)
            for b in range(row, grid, RED_ROWS):
                s = s + part[b]
            total = total + s
        sums.append(total[:c])
    return dx, sums[0], sums[1]


def _inputs(r, c, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0.5, 2.0, size=(r, c)).astype(np.float32)).to(dtype)
    dy = torch.from_numpy(rng.normal(size=(r, c)).astype(np.float32)).to(dtype)
    gamma = torch.from_numpy(rng.normal(1.0, 0.3, size=c).astype(np.float32))
    return x, dy, gamma


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("c,dtype,want", [
    (192, torch.bfloat16, (8, 3)), (384, torch.bfloat16, (16, 3)),
    (1024, torch.bfloat16, (32, 4)), (1280, torch.bfloat16, (32, 5)),
    (1408, torch.bfloat16, (32, 6)), (1001, torch.bfloat16, (32, 4)),
    (100, torch.float16, (16, 1)), (192, torch.float32, (16, 3)),
    (384, torch.float32, (32, 3)), (1280, torch.float32, (32, 10)),
])
def test_width_classes(c, dtype, want):
    """Each model width's lanes a row and chunks a lane (ViT-L 1024, ViT-H
    1280, ViT-g 1408, the predictor's 384); a row pads at most to the
    instantiated chunk counts."""
    lanes, n = width_class(c, _vec(dtype))
    assert (lanes, n) == want
    assert n * lanes * _vec(dtype) >= c


@pytest.mark.parametrize("r,lanes,grid", [(39936, 32, 132), (67584, 16, 132), (1003, 8, 132),
                                          (20, 16, 8), (1, 32, 1)])
def test_schedule_covers_each_row_once(r, lanes, grid):
    """Block b takes tiles b, b + grid, ... < tiles; every row lands in one
    (block, iteration, slot), and a block past the tiles takes none."""
    tile_rows, tiles, iters = schedule(r, lanes, grid)
    seen = torch.zeros(iters * grid * tile_rows, dtype=torch.int64)
    for b in range(grid):
        mine = [b + i * grid for i in range(iters) if b + i * grid < tiles]
        assert mine == sorted(mine)
        if b >= tiles:
            assert not mine
        for t in mine:
            seen[t * tile_rows:(t + 1) * tile_rows] += 1
    assert torch.equal(seen[:r], torch.ones(r, dtype=torch.int64))
    assert int(seen[r:].sum()) == tiles * tile_rows - r


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,c,grid", [
    (77, 192, 5),     # 8 lanes a row, a ragged last tile (77 = 2 x 32 + 13)
    (100, 384, 3),    # 16 lanes a row (bf16), a ragged last tile
    (37, 1280, 4),    # 32 lanes a row, 5 (bf16) or 10 (f32) chunks
    (20, 384, 8),     # more blocks than tiles: blocks past them add zeros
    (29, 1001, 3),    # a width that is not a multiple of the vector
    (300, 1024, None),  # the kernel's own grid, min(132, tiles)
])
def test_emulated_schedule_matches_plain(r, c, grid, dtype):
    x, dy, gamma = _inputs(r, c, dtype, seed=r + c)
    dx, dg, db = emulate_bwd(x, gamma, dy, grid=grid)
    want = ln.layer_norm_bwd_ref(x, gamma, dy)
    assert dx.dtype == dtype and dx.shape == x.shape
    name = str(dtype).split(".")[-1]
    tol = F32_REL_TOL if dtype == torch.float32 else chip_smoke.LN_REL_TOL[name]
    param_tol = F32_REL_TOL if dtype == torch.float32 else chip_smoke.LN_PARAM_REL_TOL
    assert _rel(dx, want[0]) <= tol
    assert _rel(dg, want[1]) <= param_tol
    assert _rel(db, want[2]) <= param_tol


def test_no_rows():
    """R = 0: no tile, no dx, dgamma and dbeta zero (the kernel's entry
    clears them without a launch)."""
    x, dy, gamma = _inputs(0, 384, torch.bfloat16, seed=0)
    dx, dg, db = emulate_bwd(x, gamma, dy, grid=4)
    want = ln.layer_norm_bwd_ref(x, gamma, dy)
    assert dx.shape == (0, 384)
    assert torch.equal(dg, torch.zeros(384)) and torch.equal(db, torch.zeros(384))
    assert torch.equal(want[1], dg) and torch.equal(want[2], db)
