"""Port ops vs the JAX package's ops on the same numpy inputs (CPU).

Tolerances: float32 elementwise and attention ops hold to 1e-5 absolute
(different libm / summation order); integer and boolean results (masks,
top-k filtering, argmax) must be identical. The bf16 rotary case allows
one bf16 rounding step (2e-2 absolute at |x| < 4), which still catches a
wrong cast order: rounding the 8192-sentinel angles after cos/sin instead
of before moves results by O(1).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dalle_pytorch_tpu.models.transformer import _build_static_mask
from dalle_pytorch_tpu.ops import attention_core as j_core
from dalle_pytorch_tpu.ops import masks as j_masks
from dalle_pytorch_tpu.ops import rotary as j_rot
from dalle_pytorch_tpu.ops import sampling as j_samp
from dalle_pytorch_tpu.ops import shift as j_shift
from dalle_pytorch_tpu_torch.models.transformer import build_static_mask
from dalle_pytorch_tpu_torch.ops import attention_core, masks, rotary, sampling, shift

torch.set_num_threads(2)

TEXT_LEN, FMAP, DIM_HEAD = 9, 4, 16


def _t(a):
    return torch.from_numpy(np.array(a))


def test_rotary_table_and_apply_float32():
    table = j_rot.build_dalle_rotary(TEXT_LEN, FMAP, DIM_HEAD)
    port_table = rotary.build_dalle_rotary(TEXT_LEN, FMAP, DIM_HEAD)
    assert port_table.dtype == torch.float32
    np.testing.assert_array_equal(port_table.numpy(), np.asarray(table))
    x = np.random.RandomState(0).randn(2, 4, 6, DIM_HEAD).astype(np.float32)
    ang = np.asarray(table)[7:13][None, None]  # straddles text/image rows
    ref = j_rot.apply_rotary(jnp.asarray(ang), jnp.asarray(x))
    out = rotary.apply_rotary(_t(ang), _t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_apply_rotary_bf16_rounds_angles_first():
    table = np.asarray(j_rot.build_dalle_rotary(TEXT_LEN, FMAP, DIM_HEAD))
    x = np.random.RandomState(1).randn(2, 2, 8, DIM_HEAD).astype(np.float32)
    ang = table[5:13][None, None]
    ref = j_rot.apply_rotary(jnp.asarray(ang), jnp.asarray(x, jnp.bfloat16))
    out = rotary.apply_rotary(_t(ang), _t(x).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=2e-2
    )
    same = rotary.apply_rotary(_t(ang).to(torch.bfloat16), _t(x).to(torch.bfloat16))
    assert torch.equal(out, same)


@pytest.mark.parametrize("n", [5, TEXT_LEN, TEXT_LEN + 6, TEXT_LEN + FMAP * FMAP])
def test_shift_tokens_dalle(n):
    x = np.random.RandomState(n).randn(2, n, 8).astype(np.float32)
    ref = j_shift.shift_tokens_dalle(jnp.asarray(x), TEXT_LEN, FMAP)
    out = shift.shift_tokens_dalle(_t(x), TEXT_LEN, FMAP)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_shift_ring_prefill_and_streaming_steps():
    """Prefill the text, then stream every image position: outputs and ring
    equal the reference's at each step (text, row starts, first row)."""
    rng = np.random.RandomState(3)
    total = TEXT_LEN + FMAP * FMAP
    h = rng.randn(2, total, 8).astype(np.float32)
    ring_j = j_shift.shift_ring_from_prefill(jnp.asarray(h[:, :TEXT_LEN]), FMAP)
    ring_t = shift.shift_ring_from_prefill(_t(h[:, :TEXT_LEN]), FMAP)
    np.testing.assert_array_equal(ring_t.numpy(), np.asarray(ring_j))
    for pos in range(TEXT_LEN, total):
        out_j, ring_j = j_shift.shift_token_step(
            jnp.asarray(h[:, pos : pos + 1]), ring_j, jnp.int32(pos), TEXT_LEN, FMAP
        )
        out_t, ring_t = shift.shift_token_step(
            _t(h[:, pos : pos + 1]), ring_t, pos, TEXT_LEN, FMAP
        )
        np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
        np.testing.assert_array_equal(ring_t.numpy(), np.asarray(ring_j))


@pytest.mark.parametrize("pos", [0, 3])
def test_shift_token_step_text_positions(pos):
    rng = np.random.RandomState(pos)
    h = rng.randn(2, 1, 8).astype(np.float32)
    ring = rng.randn(2, FMAP, 8).astype(np.float32)
    out_j, ring_j = j_shift.shift_token_step(
        jnp.asarray(h), jnp.asarray(ring), jnp.int32(pos), TEXT_LEN, FMAP
    )
    out_t, ring_t = shift.shift_token_step(_t(h), _t(ring.copy()), pos, TEXT_LEN, FMAP)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(ring_t.numpy(), np.asarray(ring_j))


@pytest.mark.parametrize("stable", [False, True])
def test_dense_attention(stable):
    rng = np.random.RandomState(4)
    q = rng.randn(2, 3, 5, 16).astype(np.float32)
    k = rng.randn(2, 3, 11, 16).astype(np.float32)
    v = rng.randn(2, 3, 11, 16).astype(np.float32)
    mask = rng.rand(1, 1, 5, 11) > 0.4
    mask[..., 0] = True
    for m in (None, mask):
        ref = j_core.dense_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            mask=None if m is None else jnp.asarray(m), stable=stable,
        )
        out = attention_core.dense_attention(
            _t(q), _t(k), _t(v), mask=None if m is None else _t(m), stable=stable
        )
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("stable", [False, True])
def test_dense_attention_scores_stay_float32_under_bf16_autocast(stable):
    """Under bf16 autocast (a training step's) the scores and softmax stay
    float32, as without it: the masked output equals the one computed
    outside autocast bit for bit, and equals the reference's on the same
    bf16 inputs (1e-2: the output is bf16). Autocast used to recast the
    score product to bf16, where the mask's fill value overflows."""
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(2, 3, 7, 16).astype(np.float32) for _ in range(3))
    mask = np.tril(np.ones((7, 7), bool))[None, None]
    tq, tk, tv = (_t(x).bfloat16() for x in (q, k, v))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out = attention_core.dense_attention(tq, tk, tv, mask=_t(mask), stable=stable)
    plain = attention_core.dense_attention(tq, tk, tv, mask=_t(mask), stable=stable)
    assert out.dtype == torch.bfloat16 and torch.equal(out, plain)
    ref = j_core.dense_attention(*(jnp.asarray(t.float().numpy()) for t in (tq, tk, tv)),
                                 mask=jnp.asarray(mask), stable=stable)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref), atol=1e-2, rtol=0)


def test_top_k_filter_per_row_keeps_ties():
    logits = np.array(
        [[1.0, 3.0, 3.0, 2.0, 3.0, 0.5],
         [4.0, 4.0, 1.0, 1.0, 0.0, 2.0],
         [0.0, -1.0, 5.0, 5.0, 5.0, 5.0]],
        np.float32,
    )
    keep = np.array([1, 3, 2], np.int32)
    ref = np.asarray(j_samp.top_k_filter_per_row(jnp.asarray(logits), jnp.asarray(keep)))
    for k_max in (logits.shape[-1], 3):
        out = sampling.top_k_filter_per_row(_t(logits), _t(keep), k_max)
        np.testing.assert_array_equal(out.numpy(), ref)
    # ties with the k-th survive: more kept than asked for in every row
    np.testing.assert_array_equal((~np.isinf(ref)).sum(-1), [3, 3, 4])


def test_gumbel_argmax_with_injected_noise():
    rng = np.random.RandomState(5)
    logits = rng.randn(4, 50).astype(np.float32)
    logits[1, 10:] = -np.inf
    g = rng.gumbel(size=(4, 50)).astype(np.float32)
    temps = np.array([1.0, 0.5, 0.0, 2.0], np.float32)
    ref = jnp.argmax(
        jnp.asarray(logits) / jnp.maximum(jnp.asarray(temps), 1e-4)[:, None]
        + jnp.asarray(g),
        axis=-1,
    )
    out = sampling.gumbel_sample_per_row(_t(logits), _t(temps), noise=_t(g))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_noise_keyed_by_seed_and_position_only():
    v = 97
    a = sampling.gumbel_noise([5, 7, 9], 3, v, "cpu")
    assert a.shape == (3, v) and a.dtype == torch.float32
    assert torch.isfinite(a).all()
    assert torch.equal(a, sampling.gumbel_noise([5, 7, 9], 3, v, "cpu"))
    # independent of batch composition and row index
    assert torch.equal(a[1], sampling.gumbel_noise([7], 3, v, "cpu")[0])
    assert torch.equal(a[0], sampling.gumbel_noise([9, 5], 3, v, "cpu")[1])
    # differs across seeds and positions
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(a[0], sampling.gumbel_noise([5], 4, v, "cpu")[0])


@pytest.mark.parametrize("attn_type", ["axial_row", "axial_col", "conv_like", "sparse"])
def test_static_masks_equal_reference(attn_type):
    seq_len = 8 + FMAP * FMAP
    ref = _build_static_mask(attn_type, seq_len, FMAP, 1)
    assert np.array_equal(build_static_mask(attn_type, seq_len, FMAP, 1), ref)


def test_mask_builders_equal_reference():
    assert np.array_equal(masks.causal_mask(7), j_masks.causal_mask(7))
    for axis in (0, 1):
        assert np.array_equal(
            masks.axial_static_mask(24, 4, axis), j_masks.axial_static_mask(24, 4, axis)
        )
    assert np.array_equal(
        masks.conv_like_mask(24, 4, 3, 2), j_masks.conv_like_mask(24, 4, 3, 2)
    )
    layout = masks.block_sparse_layout(64, 8, 2, None, (0,), True, 3)
    assert np.array_equal(layout, j_masks.block_sparse_layout(64, 8, 2, None, (0,), True, 3))
    assert np.array_equal(
        masks.block_layout_to_token_mask(layout, 8),
        j_masks.block_layout_to_token_mask(layout, 8),
    )
