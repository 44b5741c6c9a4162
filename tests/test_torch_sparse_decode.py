"""The port's block-sparse decode vs the JAX package's (CPU).

Host tables must be equal: `mask_to_block_bitmap` on the model's pattern
masks, and `DecodeSparsityPolicy`'s chunk and prefill bitmaps, tile
counts and summary for a ("full", "axial_row") model with a small tile
(4 positions, so tiles really are dead on a 25-position cache). The plain
block-sparse version against the JAX Pallas kernel (interpret mode) on
random bitmaps, fp32 and int8: 1e-5. An all-ones bitmap gives exactly the
plain flash-decode version's bits, as the kernel must reproduce the plain
kernel's on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models.attention import _kv_quantize as j_quantize
from dalle_pytorch_tpu.models.transformer import _build_static_mask as j_static_mask
from dalle_pytorch_tpu.ops.masks import mask_to_block_bitmap as j_mask_to_block_bitmap
from dalle_pytorch_tpu.ops.pallas_decode import (
    block_sparse_flash_decode_attention as j_sparse_decode,
)
from dalle_pytorch_tpu.serving.sparsity import DecodeSparsityPolicy as JPolicy
from dalle_pytorch_tpu_torch.models.transformer import build_static_mask
from dalle_pytorch_tpu_torch.ops.flash_decode import (
    block_sparse_flash_decode_attention,
    block_sparse_flash_decode_attention_plain,
    flash_decode_attention_plain,
)
from dalle_pytorch_tpu_torch.ops.masks import mask_to_block_bitmap
from dalle_pytorch_tpu_torch.serving.sparsity import DecodeSparsityPolicy
from test_torch_dalle import _dalle_pair

torch.set_num_threads(2)

TOTAL, FMAP = 24, 4  # text_seq 8 + 16 image tokens
BLOCK = 4


@pytest.mark.parametrize("attn_type", ["axial_row", "axial_col", "conv_like", "sparse"])
@pytest.mark.parametrize("block,n_blocks,always_live", [(4, None, 0), (8, 4, 9), (5, 7, 3)])
def test_block_bitmap_of_each_pattern_equals_the_reference(attn_type, block, n_blocks, always_live):
    mask = np.asarray(build_static_mask(attn_type, TOTAL, FMAP, 1))
    np.testing.assert_array_equal(mask, np.asarray(j_static_mask(attn_type, TOTAL, FMAP, 1)))
    ours = mask_to_block_bitmap(mask, block, n_blocks=n_blocks, always_live=always_live)
    ref = j_mask_to_block_bitmap(mask, block, n_blocks=n_blocks, always_live=always_live)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


@pytest.fixture(scope="module")
def policies():
    jm, _, pm = _dalle_pair(seed=5, attn_types=("full", "axial_row"))
    pm.decode_sparse_block = BLOCK
    return (
        JPolicy(jm.clone(decode_sparse_block=BLOCK), 3, 4),
        DecodeSparsityPolicy(pm, 3, 4),
    )


def test_policy_tables_equal_the_reference(policies):
    jpol, pol = policies
    assert (pol.block, pol.n_blocks, pol.depth) == (jpol.block, jpol.n_blocks, jpol.depth)
    assert len(pol._windows) == len(jpol._windows)
    for w, jw in zip(pol._windows, jpol._windows):
        assert (w is None) == (jw is None)
        if w is not None:
            np.testing.assert_array_equal(w, jw)
    assert pol.detail() == jpol.detail()
    np.testing.assert_array_equal(pol.prefill_bitmaps(3), jpol.prefill_bitmaps(3))


@pytest.mark.parametrize("seed", range(4))
def test_chunk_bitmaps_and_tile_counts_equal_the_reference(policies, seed):
    jpol, pol = policies
    rng = np.random.RandomState(seed)
    pos = rng.randint(0, 17, 4)
    act = rng.rand(4) < 0.7
    bm = pol.chunk_bitmaps(pos, act)
    assert bm.dtype == np.int32 and bm.shape == (2, 4, pol.n_blocks)
    np.testing.assert_array_equal(bm, jpol.chunk_bitmaps(pos, act))
    assert pol.count_tiles(pos, act) == jpol.count_tiles(pos, act)
    assert bm[0].all()  # the full layer
    if act.any():
        assert not bm[1][act].all()  # the axial layer has dead tiles


def _inputs(b, h, n, s, d, seed, int8):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, n, d).astype(np.float32)
    k, v = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(2))
    if not int8:
        return q, k, v, None, None
    (kq, ks), (vq, vs) = (j_quantize(jnp.asarray(t)) for t in (k, v))
    return q, np.array(kq), np.array(vq), np.array(ks), np.array(vs)


def _random_bitmap(b, nb, seed):
    bm = (np.random.RandomState(seed).rand(b, nb) < 0.5).astype(np.int32)
    bm[:, 0] = 1  # a row with no live block has no softmax support
    return bm


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize(
    "b,h,n,s,d,lengths,block_k",
    [
        (3, 2, 1, 40, 16, [4, 17, 40], 8),
        (3, 2, 4, 40, 32, [4, 23, 40], 8),
        (2, 2, 3, 37, 16, [20, 37], 5),
        (2, 2, 3, 40, 48, [20, 40], 8),
    ],
)
def test_plain_block_sparse_matches_the_pallas_kernel(int8, b, h, n, s, d, lengths, block_k):
    q, k, v, ks, vs = _inputs(b, h, n, s, d, seed=n + s, int8=int8)
    nb = -(-s // block_k)
    bm = _random_bitmap(b, nb, seed=b)
    lengths = np.asarray(lengths, np.int32)
    scales = {} if ks is None else dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    ref = j_sparse_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths), jnp.asarray(bm),
        block_k=block_k, interpret=True, **scales,
    )
    t = [torch.from_numpy(x) for x in (q, k, v, lengths)]
    tscales = [] if ks is None else [torch.from_numpy(ks), torch.from_numpy(vs)]
    out = block_sparse_flash_decode_attention(*t, torch.from_numpy(bm), block_k, *tscales)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_all_ones_bitmap_gives_the_plain_bits(int8, dtype):
    q, k, v, ks, vs = _inputs(4, 2, 3, 37, 16, seed=9, int8=int8)
    q = torch.from_numpy(q).to(dtype)
    k, v = (torch.from_numpy(x) if int8 else torch.from_numpy(x).to(dtype) for x in (k, v))
    scales = [] if ks is None else [torch.from_numpy(ks), torch.from_numpy(vs)]
    lengths = torch.tensor([3, 9, 20, 37], dtype=torch.int32)
    for block_k in (8, 64):  # 64 clamps to the cache: one block
        ones = torch.ones((4, -(-37 // min(block_k, 37))), dtype=torch.int32)
        out = block_sparse_flash_decode_attention(q, k, v, lengths, ones, block_k, *scales)
        assert torch.equal(out, flash_decode_attention_plain(q, k, v, lengths, *scales))


def test_wrapper_checks_the_bitmap_and_counts_no_cpu_launch():
    q, k, v, _, _ = (torch.from_numpy(x) if x is not None else None
                     for x in _inputs(2, 2, 1, 16, 16, seed=1, int8=False))
    lengths = torch.tensor([5, 16], dtype=torch.int32)
    bm = torch.tensor([[1, 0], [1, 1]], dtype=torch.int32)
    before = (block_sparse_flash_decode_attention.launches,
              block_sparse_flash_decode_attention.int8_launches)
    out = block_sparse_flash_decode_attention(q, k, v, lengths, bm, 8)
    assert torch.equal(out, block_sparse_flash_decode_attention_plain(q, k, v, lengths, bm, 8))
    assert (block_sparse_flash_decode_attention.launches,
            block_sparse_flash_decode_attention.int8_launches) == before
    with pytest.raises(ValueError, match="block_bitmap"):
        block_sparse_flash_decode_attention(q, k, v, lengths, bm[:, :1].contiguous(), 8)
    with pytest.raises(ValueError, match="block_bitmap"):
        block_sparse_flash_decode_attention(q, k, v, lengths, bm.long(), 8)
