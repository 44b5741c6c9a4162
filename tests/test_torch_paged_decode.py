"""The port's paged flash decode vs the JAX package's (CPU).

The same numpy pools, shuffled page tables (rows sharing pages) and
ragged lengths go through the JAX paged Pallas kernels (interpret mode)
and the port's wrappers, which run their plain versions on CPU tensors:
`paged_flash_decode_attention`, `block_sparse_paged_flash_decode_attention`
and `paged_decode_attention` (both impls), fp32 and int8, within atol 2e-5
/ rtol 1e-5 (float32 summation order). Bit identities the kernels must
keep on the card hold for the plain versions here: the gather impl equals
the port's slotted (block-sparse) function on the contiguous cache, and an
all-ones page bitmap equals the non-sparse paged function.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models.attention import _kv_quantize as j_quantize
from dalle_pytorch_tpu.ops.pallas_decode import (
    block_sparse_paged_flash_decode_attention as j_sparse_paged,
)
from dalle_pytorch_tpu.ops.pallas_decode import paged_decode_attention as j_paged_decode
from dalle_pytorch_tpu.ops.pallas_decode import paged_flash_decode_attention as j_paged
from dalle_pytorch_tpu.ops.pallas_decode import paged_gather as j_paged_gather
from dalle_pytorch_tpu_torch.ops.flash_decode import (
    block_sparse_flash_decode_attention,
    flash_decode_split_plain,
    block_sparse_paged_flash_decode_attention,
    flash_decode_attention,
    page_bitmap,
    paged_decode_attention,
    paged_flash_decode_attention,
    paged_gather,
)

torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=1e-5)


def _paged_case(b, h, n, page, n_pages, d, seed, int8):
    """(q, k_pages, v_pages, k_scale, v_scale, table) numpy arrays: a pool
    of random pages (int8 + scales when asked), row b's block j at a
    shuffled page, row 1 sharing row 0's first page, page 0 (garbage)
    never mapped."""
    rng = np.random.RandomState(seed)
    n_pool = 1 + b * n_pages
    k_pool, v_pool = (rng.randn(n_pool, h, page, d).astype(np.float32) for _ in range(2))
    table = (1 + rng.permutation(b * n_pages)).reshape(b, n_pages).astype(np.int32)
    if b > 1:
        table[1, 0] = table[0, 0]  # a shared prefix page
    q = rng.randn(b, h, n, d).astype(np.float32)
    ks = vs = None
    if int8:
        (k_pool, ks), (v_pool, vs) = (
            tuple(np.array(x) for x in j_quantize(jnp.asarray(t))) for t in (k_pool, v_pool)
        )
    return q, k_pool, v_pool, ks, vs, table


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


CASES = [  # b, h, n, page, n_pages, d, lengths
    (3, 2, 1, 4, 6, 16, [1, 13, 24]),
    (2, 2, 3, 8, 4, 16, [9, 30]),
    (3, 1, 2, 4, 5, 32, [5, 8, 17]),
    (2, 2, 2, 4, 5, 48, [7, 19]),  # a head dim between the kernels' old instances
    (2, 2, 1, 8, 5, 40, [9, 37]),  # not a multiple of 16: a runtime D on the card
    (2, 1, 2, 4, 6, 200, [7, 24]),  # above 128: the 256-channel instance on the card
]


def test_paged_gather_matches_the_reference():
    q, kp, vp, ks, vs, table = _paged_case(3, 2, 1, 4, 6, 16, seed=1, int8=True)
    for pool in (kp, ks):  # the reference gathers scales with a unit D
        ours = paged_gather(torch.from_numpy(pool), torch.from_numpy(table), 21)
        ref = j_paged_gather(jnp.asarray(pool.reshape(*pool.shape[:3], -1)), jnp.asarray(table), 21)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref).reshape(ours.shape))


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("b,h,n,page,n_pages,d,lengths", CASES)
def test_paged_kernel_plain_matches_the_pallas_kernel(int8, b, h, n, page, n_pages, d, lengths):
    q, kp, vp, ks, vs, table = _paged_case(b, h, n, page, n_pages, d, seed=n + page, int8=int8)
    lengths = np.asarray(lengths, np.int32)
    jq, jkp, jvp, jks, jvs, jt, jl = _j(q, kp, vp, ks, vs, table, lengths)
    ref = j_paged(jq, jkp, jvp, jl, jt, interpret=True, k_scale=jks, v_scale=jvs)
    tq, tkp, tvp, tks, tvs, tt, tl = _t(q, kp, vp, ks, vs, table, lengths)
    out = paged_flash_decode_attention(tq, tkp, tvp, tl, tt, tks, tvs)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("b,h,n,page,n_pages,d,lengths", CASES)
def test_sparse_paged_kernel_plain_matches_the_pallas_kernel(
    int8, b, h, n, page, n_pages, d, lengths
):
    q, kp, vp, ks, vs, table = _paged_case(b, h, n, page, n_pages, d, seed=2 * n + page, int8=int8)
    lengths = np.asarray(lengths, np.int32)
    bm = (np.random.RandomState(b).rand(b, n_pages) < 0.5).astype(np.int32)
    bm[:, 0] = 1  # a row with no live page has no softmax support
    jq, jkp, jvp, jks, jvs, jt, jl, jbm = _j(q, kp, vp, ks, vs, table, lengths, bm)
    ref = j_sparse_paged(jq, jkp, jvp, jl, jt, jbm, interpret=True, k_scale=jks, v_scale=jvs)
    tq, tkp, tvp, tks, tvs, tt, tl, tbm = _t(q, kp, vp, ks, vs, table, lengths, bm)
    out = block_sparse_paged_flash_decode_attention(tq, tkp, tvp, tl, tt, tbm, tks, tvs)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("sparse", [False, True], ids=["causal", "sparse"])
def test_dispatch_matches_the_reference_and_gather_is_the_slotted_function(impl, int8, sparse):
    b, h, n, page, n_pages, d = 3, 2, 1, 4, 7, 16
    vlen, sparse_block = 25, 8  # the tiny model's max_len; two pages a block
    q, kp, vp, ks, vs, table = _paged_case(b, h, n, page, n_pages, d, seed=11, int8=int8)
    lengths = np.asarray([3, 14, 25], np.int32)
    nb = -(-vlen // sparse_block)
    bm = None
    if sparse:
        bm = np.array([[1, 0, 1, 0], [1, 1, 0, 1], [1, 0, 0, 1]], np.int32)[:, :nb]
    sparse_kw = {} if bm is None else dict(block_bitmap=jnp.asarray(bm), sparse_block=sparse_block)
    jq, jkp, jvp, jks, jvs, jt, jl = _j(q, kp, vp, ks, vs, table, lengths)
    ref = j_paged_decode(jq, jkp, jvp, jl, jt, vlen, impl=impl, k_scale=jks, v_scale=jvs, **sparse_kw)
    tq, tkp, tvp, tks, tvs, tt, tl, tbm = _t(q, kp, vp, ks, vs, table, lengths, bm)
    out = paged_decode_attention(
        tq, tkp, tvp, tl, tt, vlen, impl, tks, tvs, block_bitmap=tbm,
        sparse_block=sparse_block if sparse else None,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    if impl == "gather":
        k, v = (paged_gather(t, tt, vlen) for t in (tkp, tvp))
        scales = [] if ks is None else [paged_gather(t, tt, vlen) for t in (tks, tvs)]
        if sparse:
            slotted = block_sparse_flash_decode_attention(tq, k, v, tl, tbm, sparse_block, *scales)
        else:
            slotted = flash_decode_attention(tq, k, v, tl, *scales)
        assert torch.equal(out, slotted)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_all_ones_page_bitmap_gives_the_paged_bits(int8, dtype):
    q, kp, vp, ks, vs, table = _paged_case(3, 2, 2, 4, 6, 16, seed=5, int8=int8)
    tq, tkp, tvp, tks, tvs, tt = _t(q, kp, vp, ks, vs, table)
    tq = tq.to(dtype)
    if not int8:
        tkp, tvp = tkp.to(dtype), tvp.to(dtype)
    scales = [] if ks is None else [tks, tvs]
    lengths = torch.tensor([2, 11, 24], dtype=torch.int32)
    ones = torch.ones((3, 6), dtype=torch.int32)
    out = block_sparse_paged_flash_decode_attention(tq, tkp, tvp, lengths, tt, ones, *scales)
    assert torch.equal(out, paged_flash_decode_attention(tq, tkp, tvp, lengths, tt, *scales))


def test_page_bitmap_expands_blocks_and_kills_trailing_pages():
    bm = torch.tensor([[1, 0, 1], [0, 1, 1]], dtype=torch.int32)
    out = page_bitmap(bm, 8, 4, 7)  # two pages a block; 6 covered, 1 trailing
    assert out.tolist() == [[1, 1, 0, 0, 1, 1, 0], [0, 0, 1, 1, 1, 1, 0]]
    assert page_bitmap(bm, 4, 4, 2).tolist() == [[1, 0], [0, 1]]  # cropped


def test_kernel_impl_needs_blocks_of_whole_pages():
    q, kp, vp, _, _, table = _paged_case(2, 1, 1, 4, 4, 16, seed=3, int8=False)
    tq, tkp, tvp, tt = _t(q, kp, vp, table)
    lengths = torch.tensor([5, 16], dtype=torch.int32)
    bm = torch.ones((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of page_size"):
        paged_decode_attention(tq, tkp, tvp, lengths, tt, 16, "kernel", block_bitmap=bm, sparse_block=6)
    # the gather impl reads the bitmap at its own width
    out = paged_decode_attention(tq, tkp, tvp, lengths, tt, 16, "gather", block_bitmap=bm, sparse_block=6)
    assert out.shape == tq.shape
    with pytest.raises(ValueError, match="impl"):
        paged_decode_attention(tq, tkp, tvp, lengths, tt, 16, "bogus")


def test_wrappers_check_the_table_and_count_no_cpu_launch():
    q, kp, vp, _, _, table = _paged_case(2, 2, 1, 4, 4, 16, seed=4, int8=False)
    tq, tkp, tvp, tt = _t(q, kp, vp, table)
    lengths = torch.tensor([5, 16], dtype=torch.int32)
    before = (paged_flash_decode_attention.launches, block_sparse_paged_flash_decode_attention.launches)
    paged_flash_decode_attention(tq, tkp, tvp, lengths, tt)
    block_sparse_paged_flash_decode_attention(tq, tkp, tvp, lengths, tt, torch.ones((2, 4), dtype=torch.int32))
    after = (paged_flash_decode_attention.launches, block_sparse_paged_flash_decode_attention.launches)
    assert after == before
    bad = tt.clone()
    bad[1, 2] = kp.shape[0]  # one past the pool
    with pytest.raises(ValueError, match="pool pages"):
        paged_flash_decode_attention(tq, tkp, tvp, lengths, bad)
    with pytest.raises(ValueError, match="page_table"):
        paged_flash_decode_attention(tq, tkp, tvp, lengths, tt.long())
    with pytest.raises(ValueError, match="block_bitmap"):
        block_sparse_paged_flash_decode_attention(tq, tkp, tvp, lengths, tt, torch.ones((2, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\[P, H, page, D\]"):
        paged_flash_decode_attention(tq, tkp[:, :1].contiguous(), tvp[:, :1].contiguous(), lengths, tt)


@pytest.mark.parametrize("sparse", [False, True], ids=["causal", "sparse"])
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("d", [16, 40])
def test_split_k_model_on_the_pool_matches_the_pallas_kernels(d, int8, sparse):
    """`flash_decode_split_plain` reading the pool through the page table
    (the paged kernels' split-K arithmetic: spans of 8 positions, two
    pages each) against the paged Pallas kernels in interpret mode, with
    ragged lengths (not multiples of the span) and a page bitmap that
    leaves whole spans dead: 2e-5 (float32 summation order)."""
    b, h, n, page, n_pages = 3, 2, 1, 4, 9
    q, kp, vp, ks, vs, table = _paged_case(b, h, n, page, n_pages, d, seed=d + int8, int8=int8)
    lengths = np.asarray([3, 22, 36], np.int32)
    bm = None
    if sparse:
        bm = np.zeros((b, n_pages), np.int32)
        bm[:, 0] = 1
        bm[1, [1, 4, 5]] = 1  # span 1 (pages 2-3) dead for row 1
        bm[2, [3, 6, 8]] = 1  # spans 2 and half of 1 dead for row 2
    jq, jkp, jvp, jks, jvs, jt, jl = _j(q, kp, vp, ks, vs, table, lengths)
    if sparse:
        ref = j_sparse_paged(jq, jkp, jvp, jl, jt, jnp.asarray(bm), interpret=True,
                             k_scale=jks, v_scale=jvs)
    else:
        ref = j_paged(jq, jkp, jvp, jl, jt, interpret=True, k_scale=jks, v_scale=jvs)
    tq, tkp, tvp, tks, tvs, tt, tl, tbm = _t(q, kp, vp, ks, vs, table, lengths, bm)
    out = flash_decode_split_plain(tq, tkp, tvp, tl, tks, tvs, block_bitmap=tbm, page_table=tt, span=8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
