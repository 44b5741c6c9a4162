"""Flash decode's fp32 multi-row kernels on the CPU: the fp32 tile arm
(`csrc/flash_decode_tile_f32.cu`, D <= 256) and, above 256 channels,
`wide_decode_fma_kernel` (`csrc/wide_head.cu`).

The card runs them for fp32 q at n > DECODE_ROWS query rows (the prefill
chunk and the resume forward of a model served in fp32);
`flash_decode_tile_f32_plain` is their arithmetic in plain PyTorch (tiles
of `tile_f32_keys(D)` keys in order, q scaled before the product, P = e^(S
- m) in fp32, an int8 cache dequantized first, keys no row reads zeroed).
Here the model meets the JAX package's Pallas kernels, run in interpret
mode as the JAX tests run them, for every decode variant (plain,
block-sparse, paged, block-sparse paged; each with its int8 arm), and
itself for the bit identities the kernel keeps on the card. The kernel is
held against the plain version and this model on the card by
`chip_smoke.py` (phases 2-4).

Tolerance: 2e-5 absolute, `chip_smoke.py`'s fp32 `decode_tol` (summation
order only: the arithmetic is the reference's). A row that sees no key
is zeros in the port (its contract), where the Pallas kernel gives the
mean of a V tile: such rows are compared with the plain version only.
"""

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch.ops import flash_decode as fd
from test_torch_decode_tile import (
    B,
    BLOCK_K,
    DIMS,
    PAGE,
    ROWS,
    S_LEN,
    VARIANTS,
    _case,
    _lengths,
    _pallas,
    _plain,
    _t,
    _visible_rows,
)

torch.set_num_threads(2)


def _model(variant, q, k, v, ks, vs, lengths, bm, table, pools):
    paged = "paged" in variant
    kk, vv, sk, sv = pools if paged else (k, v, ks, vs)
    return fd.flash_decode_tile_f32_plain(
        _t(q), _t(kk), _t(vv), _t(lengths), _t(sk), _t(sv),
        block_bitmap=_t(bm), block_k=None if paged else BLOCK_K, page_table=_t(table),
    )


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_f32_tile_model_matches_the_pallas_kernels(variant, n):
    """The fp32 tile model against the Pallas kernel of each decode variant
    (rows 1-5 of the kernel table, both arms), fp32 q: over one and more
    64-row query tiles and several key tiles (64 keys at D = 40 and 64,
    32 at D = 200: each variant meets all three head dims across its four
    n), lengths below n and on a 64-key tile edge, a random bitmap and a
    shuffled page table whose 40-position pages straddle the key tiles.
    2e-5."""
    d = DIMS[(VARIANTS.index(variant) + ROWS.index(n)) % len(DIMS)]
    q, k, v, ks, vs, bm, table, pools = _case(variant, n, d, seed=11 * n + d)
    lengths = _lengths(n)
    out = _model(variant, q, k, v, ks, vs, lengths, bm, table, pools)
    assert out.shape == (B, 2, n, d) and out.dtype == torch.float32 and torch.isfinite(out).all()
    ref = np.asarray(_pallas(variant, q, k, v, ks, vs, lengths, bm, table, pools, torch.float32))
    seen = _visible_rows(variant, n, lengths, bm)
    assert (~seen).any() and seen.any()  # both kinds of rows are exercised
    got = out.numpy()
    mask = np.broadcast_to(seen[:, None, :, None], got.shape)
    np.testing.assert_allclose(got[mask], ref[mask], atol=2e-5, rtol=0)
    plain = _plain(variant, q, k, v, ks, vs, lengths, bm, torch.float32).numpy()
    assert (got[~mask] == 0).all() and (plain[~mask] == 0).all()


@pytest.mark.parametrize("d", [264, 320])
@pytest.mark.parametrize("n", [5, 65])
@pytest.mark.parametrize("variant", VARIANTS)
def test_f32_tile_model_above_256_matches_the_pallas_kernels(variant, n, d):
    """The model of `wide_decode_fma_kernel` (fp32 q at n > 4 above 256
    channels: `flash_decode_tile_f32_plain` with 64-key tiles) against the
    Pallas kernel of each decode variant, both arms, at D = 264 and 320, n
    = 5 and 65 (one and two 64-row query tiles), on the cases of the test
    above. 2e-5."""
    assert fd.decode_arm(n, torch.float32, d) == "wide_tile_f32" and fd.tile_f32_keys(d) == 64
    q, k, v, ks, vs, bm, table, pools = _case(variant, n, d, seed=11 * n + d)
    lengths = _lengths(n)
    out = _model(variant, q, k, v, ks, vs, lengths, bm, table, pools)
    assert out.shape == (B, 2, n, d) and out.dtype == torch.float32 and torch.isfinite(out).all()
    ref = np.asarray(_pallas(variant, q, k, v, ks, vs, lengths, bm, table, pools, torch.float32))
    seen = _visible_rows(variant, n, lengths, bm)
    got = out.numpy()
    mask = np.broadcast_to(seen[:, None, :, None], got.shape)
    np.testing.assert_allclose(got[mask], ref[mask], atol=2e-5, rtol=0)
    assert (got[~mask] == 0).all()


@pytest.mark.parametrize("variant", ["plain", "int8"])
@pytest.mark.parametrize("d", [40, 200])
def test_f32_tile_model_is_the_plain_function(d, variant):
    """Without a bitmap the tiles, the online softmax and the zero-filled
    keys leave the plain version's function (summation order): 2e-6, on
    the int8 arm too."""
    q, k, v, ks, vs, _, _, _ = _case(variant, 130, d, seed=d)
    sc = () if ks is None else (_t(ks), _t(vs))
    args = (_t(q), _t(k), _t(v), _t(_lengths(130)), *sc)
    torch.testing.assert_close(fd.flash_decode_tile_f32_plain(*args), fd.flash_decode_attention_plain(*args),
                               atol=2e-6, rtol=0)


@pytest.mark.parametrize("n", [5, 130])
@pytest.mark.parametrize("int8", [False, True])
def test_f32_tile_model_bit_identities(int8, n):
    """The identities the kernel keeps on the card, held by its model: an
    all-ones bitmap gives the plain variant's bits (contiguous and paged),
    and the paged variants give the contiguous ones' bits on the gathered
    view, bitmap or not."""
    _hold_bit_identities(int8, n, 64)


@pytest.mark.parametrize("int8", [False, True])
def test_f32_tile_model_bit_identities_above_256(int8):
    """The same identities at D = 320 (`wide_decode_fma_kernel`'s model,
    64-key tiles), n = 65."""
    _hold_bit_identities(int8, 65, 320)


def _hold_bit_identities(int8, n, d):
    variant = "block_sparse_paged" + ("_int8" if int8 else "")
    q, k, v, ks, vs, bm, table, pools = _case(variant, n, d, seed=n + 1)
    lengths = _t(_lengths(n))
    tq, kp, vp = _t(q), _t(pools[0]), _t(pools[1])
    sc = () if ks is None else tuple(_t(x) for x in pools[2:])
    tt, tb = _t(table), _t(bm)
    ones = torch.ones_like(tb)
    model = fd.flash_decode_tile_f32_plain
    plain_paged = model(tq, kp, vp, lengths, *sc, page_table=tt)
    assert torch.equal(model(tq, kp, vp, lengths, *sc, block_bitmap=ones, page_table=tt), plain_paged)
    kg, vg = (fd.paged_gather(x, tt, S_LEN) for x in (kp, vp))
    scg = tuple(fd.paged_gather(x, tt, S_LEN) for x in sc)
    contiguous = model(tq, kg, vg, lengths, *scg)
    assert torch.equal(plain_paged, contiguous)
    assert torch.equal(model(tq, kg, vg, lengths, *scg, block_bitmap=ones, block_k=PAGE), contiguous)
    assert torch.equal(model(tq, kp, vp, lengths, *sc, block_bitmap=tb, page_table=tt),
                       model(tq, kg, vg, lengths, *scg, block_bitmap=tb, block_k=PAGE))


@pytest.mark.parametrize("int8", [False, True])
def test_f32_tile_model_never_reads_keys_no_row_sees(int8):
    """NaN in every cache position past each row's length and in each dead
    block (in the scales of an int8 cache) leaves the model's output
    finite and unchanged: those keys enter as zeros, as the kernel
    zero-fills them."""
    _hold_poisoned_cache(int8, 64)


@pytest.mark.parametrize("int8", [False, True])
def test_f32_tile_model_never_reads_keys_no_row_sees_above_256(int8):
    """The same at D = 320 (`wide_decode_fma_kernel`'s model)."""
    _hold_poisoned_cache(int8, 320)


def _hold_poisoned_cache(int8, d):
    variant = "block_sparse" + ("_int8" if int8 else "")
    q, k, v, ks, vs, bm, _, _ = _case(variant, 65, d, seed=12)
    tq, tk, tv, tl, tb = _t(q), _t(k), _t(v), _t(_lengths(65)), _t(bm)
    sc = () if ks is None else (_t(ks), _t(vs))
    clean = fd.flash_decode_tile_f32_plain(tq, tk, tv, tl, *sc, block_bitmap=tb, block_k=BLOCK_K)
    dead = ~(torch.arange(S_LEN)[None, :] < tl[:, None].long()) | ~fd.expand_bitmap(tb, BLOCK_K, S_LEN)
    if sc:
        sc = tuple(t.masked_fill(dead[:, None], float("nan")) for t in sc)
    else:
        tk, tv = (t.masked_fill(dead[:, None, :, None], float("nan")) for t in (tk, tv))
    poisoned = fd.flash_decode_tile_f32_plain(tq, tk, tv, tl, *sc, block_bitmap=tb, block_k=BLOCK_K)
    assert torch.isfinite(poisoned).all() and torch.equal(poisoned, clean)


def test_f32_tile_keys_shrink_above_128_channels():
    """64 keys a tile up to D = 128 and 32 above (two fp32 stages of 64
    keys beside the Q tile pass a block's shared memory at 256); query
    tiles of 64 rows. Above 256 channels `wide_decode_fma_kernel` takes
    64-key tiles again (its ring holds channel slices of a tile)."""
    assert [fd.tile_f32_keys(d) for d in (1, 64, 128, 129, 200, 256)] == [64, 64, 64, 32, 32, 32]
    assert [fd.tile_f32_keys(d) for d in (257, 320, 512, 1024, 2048)] == [64] * 5
    assert fd.DECODE_TILE_F32_ROWS == 64


def test_cpu_wrappers_count_no_f32_tile_launch():
    """On CPU tensors every wrapper runs its plain version for fp32 q at n
    > 4, counting no launch of either tile arm."""
    q, k, v, _, _, bm, table, pools = _case("block_sparse_paged", 65, 64, seed=2)
    tq, tk, tv, tl, tb, tt = _t(q), _t(k), _t(v), _t(_lengths(65)), _t(bm), _t(table)
    kp, vp = _t(pools[0]), _t(pools[1])
    fns = [fd.flash_decode_attention, fd.block_sparse_flash_decode_attention,
           fd.paged_flash_decode_attention, fd.block_sparse_paged_flash_decode_attention]
    counts = lambda: [(f.launches, f.tile_f32_launches, f.tile_f32_int8_launches) for f in fns]  # noqa: E731
    before = counts()
    assert torch.equal(fd.flash_decode_attention(tq, tk, tv, tl), fd.flash_decode_attention_plain(tq, tk, tv, tl))
    fd.block_sparse_flash_decode_attention(tq, tk, tv, tl, torch.ones((B, 7), dtype=torch.int32), BLOCK_K)
    fd.paged_flash_decode_attention(tq, kp, vp, tl, tt)
    fd.block_sparse_paged_flash_decode_attention(tq, kp, vp, tl, tt, tb)
    assert counts() == before
