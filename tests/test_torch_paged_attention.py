"""Paged-attention parity: the port's plain versions against the JAX
oracles and Pallas kernels (interpret mode) on the CPU; the CUDA kernels
against the plain versions on the card.

Tolerance rtol=atol=2e-5 (the JAX package's own bound for these kernels,
``tests/test_grouped_decode.py``): both sides compute f32 softmax and
differ in reduction order only. The K/V write is a copy and is compared
bitwise.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyrl_tpu.models.decoder import _scatter_token_kv
from polyrl_tpu.ops import paged_attention as jpa
from polyrl_tpu_torch.ops import cuda_build
from polyrl_tpu_torch.ops import paged_attention as tpa
from test_torch_cuda_kernels import PAGE, grouped_case as _grouped_case

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(case):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in case]


@pytest.mark.parametrize("hq,hkv,d,lens", [
    (4, 2, 16, (1, 8, 9, 23)),
    (8, 8, 32, (5, 16, 17, 0)),     # rep 1; an empty row (len 0)
    (8, 2, 16, (24, 2, 11, 7)),     # rep 4
])
def test_paged_attention_plain_matches_jax(hq, hkv, d, lens):
    rng = np.random.default_rng(hq * 100 + d)
    n_pool, p = 40, 3
    q = rng.standard_normal((len(lens), hq, d)).astype(np.float32)
    kp = rng.standard_normal((hkv, n_pool, PAGE, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, n_pool, PAGE, d)).astype(np.float32)
    table = rng.permutation(np.arange(1, n_pool))[:len(lens) * p].reshape(
        len(lens), p).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    ref = np.asarray(jpa.paged_attention_ref(q, kp, vp, table, lens))
    pal = np.asarray(jpa.paged_attention_pallas(q, kp, vp, table, lens,
                                                interpret=True))
    out = tpa.paged_attention(*_t((q, kp, vp, table, lens))).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, pal, **TOL)
    assert np.isfinite(out).all()


@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("rep", [1, 2, 4])
def test_grouped_plain_matches_jax(g, rep):
    rng = np.random.default_rng(g * 10 + rep)
    case = _grouped_case(rng, groups=((g, 2, (3, 9, 1, 5)),), rep=rep)
    gref = np.asarray(jpa.grouped_paged_attention_ref(*case))
    gpal = np.asarray(jpa.grouped_paged_attention_pallas(*case, interpret=True))
    out = tpa.grouped_paged_attention(*_t(case)).numpy()
    full = tpa.paged_attention(*_t(case[:5])).numpy()
    np.testing.assert_allclose(out, gref, **TOL)
    np.testing.assert_allclose(out, gpal, **TOL)
    np.testing.assert_allclose(out, full, **TOL)


@pytest.mark.parametrize("n_pre", [1, 2, 3])
def test_grouped_prefix_boundaries(n_pre):
    """Prefix chains of 1..3 pages; suffixes just before, on and after
    their own page boundary."""
    rng = np.random.default_rng(n_pre)
    case = _grouped_case(rng, groups=((3, n_pre, (PAGE - 1, PAGE, PAGE + 1)),))
    gref = np.asarray(jpa.grouped_paged_attention_ref(*case))
    out = tpa.grouped_paged_attention(*_t(case)).numpy()
    np.testing.assert_allclose(out, gref, **TOL)


def test_grouped_masked_seat_and_empty_row():
    """A -1 seat mid-row (a finished sibling) plus the pow2 padding seats
    must never be used as an index: in torch a -1 would wrap to the last
    slot. The last slot here is an ungrouped row of length 0 (an empty
    row), which must come out exactly as plain attention computes it."""
    rng = np.random.default_rng(7)
    case = list(_grouped_case(rng, groups=((4, 2, (3, 9, 1, 5)), (3, 1, (6, 2))),
                              ungrouped_lens=(11, 5, 0)))
    case[5][0, 2] = -1
    gs = case[5]
    assert (gs == -1).sum() >= 2
    gref = np.asarray(jpa.grouped_paged_attention_ref(*case))
    gpal = np.asarray(jpa.grouped_paged_attention_pallas(*case, interpret=True))
    out = tpa.grouped_paged_attention(*_t(case)).numpy()
    full = tpa.paged_attention(*_t(case[:5])).numpy()
    np.testing.assert_allclose(out, gref, **TOL)
    np.testing.assert_allclose(out, gpal, **TOL)
    np.testing.assert_allclose(out, full, **TOL)
    grp, col, npre = tpa._group_slot_maps(torch.from_numpy(gs),
                                          torch.from_numpy(case[7]),
                                          q_s := case[0].shape[0], PAGE)
    assert int(grp[q_s - 1]) == -1 and int(npre[q_s - 1]) == 0
    assert int(grp[2]) == -1  # the masked seat's slot runs ungrouped


def test_paged_attention_plain_long_rows_match_jax():
    """Rows over many pages (up to 40 of 8 positions), with lengths on,
    just before and just past a page boundary, and an empty row."""
    rng = np.random.default_rng(31)
    hq, hkv, d, p = 8, 2, 32, 40
    lens = np.asarray([320, 319, 161, 1, 0, 257], np.int32)
    n_pool = len(lens) * p + 1
    q = rng.standard_normal((len(lens), hq, d)).astype(np.float32)
    kp = rng.standard_normal((hkv, n_pool, PAGE, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, n_pool, PAGE, d)).astype(np.float32)
    table = rng.permutation(np.arange(1, n_pool))[:len(lens) * p].reshape(
        len(lens), p).astype(np.int32)
    ref = np.asarray(jpa.paged_attention_ref(q, kp, vp, table, lens))
    out = tpa.paged_attention(*_t((q, kp, vp, table, lens))).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    assert np.isfinite(out).all()


@pytest.mark.parametrize("n_pre,rep", [(5, 2), (12, 1)])
def test_grouped_plain_multi_page_prefix_matches_jax(n_pre, rep):
    """Prefixes of several pages (more than one chunk of K2/K3's split),
    suffixes from one token to several pages, a -1 seat mid-row."""
    rng = np.random.default_rng(40 + n_pre)
    case = list(_grouped_case(rng, groups=((4, n_pre, (1, 17, 30, 8)),
                                           (2, 3, (PAGE + 1, 2))),
                              rep=rep, ungrouped_lens=(90, 0), n_pool=160))
    case[5][0, 1] = -1
    gref = np.asarray(jpa.grouped_paged_attention_ref(*case))
    gpal = np.asarray(jpa.grouped_paged_attention_pallas(*case, interpret=True))
    out = tpa.grouped_paged_attention(*_t(case)).numpy()
    full = tpa.paged_attention(*_t(case[:5])).numpy()
    np.testing.assert_allclose(out, gref, **TOL)
    np.testing.assert_allclose(out, gpal, **TOL)
    np.testing.assert_allclose(out, full, **TOL)


@pytest.mark.parametrize("p", [1, 3, 64])
@pytest.mark.parametrize("s,hkv,page", [(1, 1, 16), (64, 8, 64), (5, 4, 8),
                                        (64, 8, 256)])
def test_chunk_plan_covers_every_page_once(p, s, hkv, page):
    """K2/K3's work items cut each page-table row into ceil(P / C) chunks of
    C columns: every column of every row lies in exactly one chunk, C
    follows from the shapes alone, an item covers at most 256 positions
    (or one page), and C only shrinks below that to offer the card more
    items."""
    c = tpa.chunk_pages(s, hkv, p, page)
    n_chunks = -(-p // c)
    assert 1 <= c <= p
    assert c * page <= max(page, tpa.CHUNK_POSITIONS)
    seen = np.zeros((p,), np.int32)
    for k in range(n_chunks):
        seen[k * c:min((k + 1) * c, p)] += 1
    assert (seen == 1).all()
    bigger = max(1, min(p, tpa.CHUNK_POSITIONS // page))
    while bigger > c:  # each bigger chunk passed over offered too few items
        assert s * hkv * -(-p // bigger) < tpa.FILL_ITEMS
        bigger //= 2
    assert bigger == c


def test_chunk_plan_fits_the_kernels_page_id_buffer():
    """The split kernels read an item's page ids into a buffer of kMaxCols
    entries and refuse a larger C; chunk_pages never asks for more, at any
    page size."""
    src = (cuda_build.CSRC_DIR / "paged_common.cuh").read_text()
    max_cols = int(re.search(r"constexpr int kMaxCols = (\d+);", src).group(1))
    for page in (1, 2, 16, 64, 512):
        assert tpa.chunk_pages(1, 1, 4096, page) <= max_cols


def test_kv_write_bitwise_vs_pallas_and_scatter():
    rng = np.random.default_rng(5)
    hkv, n, d, s = 2, 16, 16, 6
    kp = rng.standard_normal((hkv, n, PAGE, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, n, PAGE, d)).astype(np.float32)
    ku = rng.standard_normal((s, hkv, d)).astype(np.float32)
    vu = rng.standard_normal((s, hkv, d)).astype(np.float32)
    page = np.array([3, 7, 0, 12, 0, 5], np.int32)   # two inactive -> page 0
    off = np.array([0, 7, 0, 3, 0, 4], np.int32)
    ku[4] = ku[2]  # both null-page writes carry the same row: order-free
    vu[4] = vu[2]
    jk, jv = jpa.paged_kv_write_pallas(kp, vp, page, off, ku, vu,
                                       interpret=True)
    sk = _scatter_token_kv(jnp.asarray(kp), page, off, ku)
    tk, tv = tpa.paged_kv_write(*_t((kp, vp, page, off, ku, vu)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(sk))


def test_cpu_wrappers_do_not_count_launches():
    cuda_build.reset_launch_counts()
    rng = np.random.default_rng(0)
    case = _grouped_case(rng)
    tpa.grouped_paged_attention(*_t(case))
    tpa.paged_attention(*_t(case[:5]))
    kp, vp = _t(case[1:3])
    s, hkv, d = 3, kp.shape[0], kp.shape[3]
    page, off = torch.tensor([1, 0, 2]).int(), torch.tensor([0, 0, 7]).int()
    k = torch.from_numpy(rng.standard_normal((s, hkv, d)).astype(np.float32))
    tpa.paged_kv_write(kp, vp, page, off, k, k.clone())
    q = tpa.paged_kv_write_fused(
        kp, vp, page, off, torch.zeros((s, 2 * hkv * d)), k.reshape(s, -1),
        k.reshape(s, -1).clone(), torch.ones((s, d // 2)),
        torch.zeros((s, d // 2)), torch.ones(d), torch.ones(d))
    assert q.shape == (s, 2 * hkv, d)
    assert set(cuda_build.LAUNCHES) >= {"paged_kv_write", "paged_kv_write_fused"}
    assert all(v == 0 for v in cuda_build.LAUNCHES.values())
