"""K4's tile decisions on the CPU, against brute force over visible pairs.

The bf16 kernels decide on the device which (q tile, k tile) pairs to
compute: each 64-row tile's (min, max) segment id (``segment_tile_ranges``,
the plain version of ``flash_seg_ranges_kernel``), a pair skipped when the
two ranges are disjoint (``tile_pairs_run``), a pair computed without the
per-element mask when both tiles hold one id (``tile_pairs_uniform``). The
backward spreads a kv head's q heads over blocks (``dkv_splits``) and adds
their dk/dv partials in a fixed order (``dkv_partials_ref``,
``dkv_sum_ref``). Each is held here against the mask itself: a skipped
pair holds no visible (query, key) pair, an unmasked pair holds nothing
but visible pairs, and the split sum equals the unsplit gradient.
"""

import numpy as np
import pytest
import torch

from polyrl_tpu_torch.ops import flash

TILE = flash.TILE


def visible(seg: torch.Tensor, causal: bool) -> torch.Tensor:
    """[B, T, T] bool: query i sees key j (the kernels' mask)."""
    t = seg.shape[1]
    vis = seg[:, :, None] == seg[:, None, :]
    if causal:
        vis = vis & torch.ones((t, t), dtype=torch.bool).tril()
    return vis


def pair_counts(seg: torch.Tensor, causal: bool) -> torch.Tensor:
    """[B, n, n] visible pairs in each (q tile, k tile), T padded to tiles."""
    b, t = seg.shape
    n = -(-t // TILE)
    vis = torch.zeros((b, n * TILE, n * TILE), dtype=torch.int64)
    vis[:, :t, :t] = visible(seg, causal).long()
    return vis.view(b, n, TILE, n, TILE).sum((2, 4))


def packed(rng, b: int, t: int, lo: int, hi: int, head: int = 0, tail: int = 0):
    """[b, t] int32 ids: ``head`` left pads, then segments 1, 2, ... of
    lengths in [lo, hi), then pads from ``t - tail`` on (id 0)."""
    seg = np.zeros((b, t), np.int32)
    for r in range(b):
        pos, sid = head, 1
        while pos < t - tail:
            n = min(int(rng.integers(lo, hi)), t - tail - pos)
            seg[r, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
    return torch.from_numpy(seg)


def check_tiles(seg: torch.Tensor, causal: bool) -> None:
    b, t = seg.shape
    n = -(-t // TILE)
    ranges = flash.segment_tile_ranges(seg)
    assert ranges.shape == (b, n, 2) and ranges.dtype == torch.int32
    for i in range(n):  # brute force: each tile's ids inside T
        rows = seg[:, i * TILE:min(t, (i + 1) * TILE)]
        assert torch.equal(ranges[:, i, 0], rows.amin(1).int())
        assert torch.equal(ranges[:, i, 1], rows.amax(1).int())
    counts = pair_counts(seg, causal)
    run = flash.tile_pairs_run(ranges, causal)
    assert not (counts[~run] > 0).any(), "a skipped pair holds a visible pair"
    full = torch.zeros((n,), dtype=torch.int64)
    full[:] = TILE
    full[-1] = t - (n - 1) * TILE
    uniform = flash.tile_pairs_uniform(ranges, t, causal)
    tile_pairs = full[:, None] * full[None, :]
    assert torch.equal(counts[uniform], tile_pairs.expand(b, n, n)[uniform]), \
        "an unmasked pair holds a hidden pair"
    assert not (uniform & ~run).any()
    n_run, n_skip = flash.tiles_run(ranges, causal)
    allowed = b * (n * (n + 1) // 2 if causal else n * n)
    assert (n_run, n_skip) == (int(run.sum()), allowed - int(run.sum()))


def random_pack(seed: int) -> tuple[torch.Tensor, bool]:
    """A seeded draw of a pack: 1-3 rows of 1-300 ids, segments of a
    random length range, a pad head and tail of up to a third of the row
    each, causal or not."""
    rng = np.random.default_rng(seed)
    b, t = int(rng.integers(1, 4)), int(rng.integers(1, 301))
    lo = int(rng.integers(1, 121))
    hi = lo + int(rng.integers(1, 201))
    head = int(rng.integers(0, t // 3 + 1))
    tail = int(rng.integers(0, (t - head) // 3 + 1))
    return packed(rng, b, t, lo, hi, head, tail), bool(rng.integers(0, 2))


@pytest.mark.parametrize("seed", range(60))
def test_tile_decisions_against_brute_force_on_random_packs(seed):
    check_tiles(*random_pack(seed))


@pytest.mark.parametrize("t,head,tail,lo,hi", [
    (200, 0, 0, 20, 90),     # T a multiple of no tile, no pads
    (200, 37, 0, 500, 501),  # one segment after a pad head
    (193, 0, 17, 30, 31),    # one real row in the last tile, a pad tail
    (64, 0, 0, 64, 65),      # one full tile, one id
    (65, 5, 5, 8, 24),       # many short segments over two tiles
    (1, 0, 0, 1, 2),         # a single row
    (1000, 3, 9, 20, 90),    # many short segments: most pairs skipped
])
@pytest.mark.parametrize("causal", [True, False])
def test_tile_decisions_at_pads_and_ragged_tiles(t, head, tail, lo, hi, causal):
    rng = np.random.default_rng(t + head + tail)
    check_tiles(packed(rng, 2, t, lo, hi, head, tail), causal)


def test_uniform_rows_skip_nothing_and_mask_nothing_inside():
    """Rows of one id, T a multiple of the tile: every causal pair runs, and
    every pair strictly below the diagonal needs no mask."""
    seg = torch.ones((2, 4 * TILE), dtype=torch.int32)
    run = flash.tile_pairs_run(flash.segment_tile_ranges(seg), True)
    uni = flash.tile_pairs_uniform(flash.segment_tile_ranges(seg), 4 * TILE, True)
    tri = torch.ones((4, 4), dtype=torch.bool)
    assert torch.equal(run, tri.tril().expand(2, 4, 4))
    assert torch.equal(uni, tri.tril(-1).expand(2, 4, 4))
    assert flash.tiles_run(flash.segment_tile_ranges(seg)) == (20, 0)


def ppo_like_pack(seed: int) -> torch.Tensor:
    """4 rows of 1024 packed as the ppo phase's trainer packs them: about 4
    trajectories of 128-384 tokens a row, then a pad tail, so that about a
    quarter of the causal (query, key) pairs are visible (the ppo phase's
    rows: 526,863 of 4 x 1024 x 1025 / 2 a head, PERF.md)."""
    rng = np.random.default_rng(seed)
    seg = torch.cat([packed(rng, 1, 1024, 128, 384, 0, int(rng.integers(0, 40)))
                     for _ in range(4)])
    return seg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ppo_like_pack_runs_about_half_the_causal_tiles(seed):
    """At 64-row tiles a quarter of the pairs visible is about half of the
    causal tile pairs run: a tile that straddles two trajectories meets
    both, and the last tile, with the pad tail's id 0, meets every tile of
    its row. The skipped half holds no visible pair."""
    seg = ppo_like_pack(seed)
    share = visible(seg, True).sum().item() / (4 * 1024 * 1025 / 2)
    assert 0.2 <= share <= 0.3
    run, skipped = flash.tiles_run(flash.segment_tile_ranges(seg))
    assert run + skipped == 4 * 16 * 17 // 2
    assert 0.4 <= run / (run + skipped) <= 0.55, run / (run + skipped)
    check_tiles(seg, True)


@pytest.mark.parametrize("b,t,hq,hkv,want", [
    (4, 512, 16, 8, 1),    # train shapes: 256 blocks unsplit
    (4, 512, 32, 4, 2),    # rep 8: 128 blocks unsplit
    (1, 4096, 16, 8, 1),   # long rows fill the card unsplit
    (2, 1024, 32, 4, 2),
    (1, 64, 8, 1, 8),      # never past one q head a block
    (1, 200, 8, 2, 4),
    (2, 200, 8, 8, 1),     # rep 1: nothing to split
])
def test_dkv_splits_fill_the_card_and_divide_rep(b, t, hq, hkv, want):
    n = flash.dkv_splits(b, t, hq, hkv)
    assert n == want and (hq // hkv) % n == 0
    blocks = -(-t // TILE) * hkv * b
    assert blocks * n >= flash.DKV_MIN_BLOCKS or n == hq // hkv


@pytest.mark.parametrize("hq,hkv,n_split", [(8, 2, 2), (8, 2, 4), (8, 1, 4), (4, 2, 1)])
def test_split_partials_sum_to_the_unsplit_gradient(hq, hkv, n_split):
    """The fixed-order sum of the split backward's dk/dv partials equals
    the dk/dv of autograd through ``flash_attention_train_ref`` (f32,
    reduction order only), on a pack with pads."""
    rng = np.random.default_rng(hq * 10 + n_split)
    b, t, d = 2, 80, 16
    seg = packed(rng, b, t, 10, 40, 3, 5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                   for shape in ((b, t, hq, d), (b, t, hkv, d), (b, t, hkv, d),
                                 (b, t, hq, d)))
    parts = flash.dkv_partials_ref(q, k, v, seg, do, n_split)
    assert parts.shape == (2, n_split, b, t, hkv, d)
    dk, dv = flash.dkv_sum_ref(parts)
    kk, vv = (x.clone().requires_grad_(True) for x in (k, v))
    out = flash.flash_attention_train_ref(q, kk, vv, (seg > 0).float(), segment_ids=seg)
    rdk, rdv = torch.autograd.grad(out, (kk, vv), do)
    torch.testing.assert_close(dk, rdk, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(dv, rdv, rtol=2e-5, atol=2e-5)
    # the same partials summed again: the order is fixed, the sum bitwise
    dk2, dv2 = flash.dkv_sum_ref(parts.clone())
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.parametrize("dtype,with_table", [(torch.bfloat16, False),
                                               (torch.float32, True)])
def test_launchers_take_the_table_for_bf16_only(dtype, with_table):
    """The bf16 kernels take the tile ranges and the f32 ones none: a
    launcher given the wrong one raises before it launches."""
    b, t, h, d = 1, 8, 2, 64
    q = torch.zeros((b, t, h, d), dtype=dtype)
    seg = torch.ones((b, t), dtype=torch.int32)
    ranges = flash.segment_tile_ranges(seg) if with_table else None
    with pytest.raises(ValueError, match="tile ranges"):
        flash.flash_fwd_cuda(q, q, q, seg, True, ranges)
    with pytest.raises(ValueError, match="tile ranges"):
        flash.flash_bwd_cuda(q, q, q, seg, q, None, q, True, ranges)
