"""The head-dim > 256 kernels of the port (`ops/wide_head.py`,
`csrc/wide_head.cu`) on the CPU: which kernel a call launches on the card
at (D, dtype), the bf16 kernels' launch plans at every D from 257 to 1024,
and the arithmetic of the bf16 tensor-core kernels (the plain versions
with `p_dtype=bfloat16`: P rounded per 64-key tile in base 2 forward, dS
rounded once backward) against the JAX package's Pallas kernels in
interpret mode at D = 264 and 320; and the split-K decode step's
arithmetic (`flash_decode_split_plain` with spans of DECODE_SPAN keys)
against the Pallas decode kernels at D = 264 and 320 (2e-5, float32
summation order).

Tolerances: the rounding-matched plain versions against the exact Pallas
function 2^-8 of the largest |reference| (bf16 rounds P and dS to 2^-9
relative, each output sums such terms); the padded wrapper's arithmetic
against the unpadded plain version 1e-6 (zero channels change only the
summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.ops.pallas_attention import flash_attention as jax_flash_attention
from dalle_pytorch_tpu_torch.models.transformer import build_static_mask
from dalle_pytorch_tpu_torch.ops import flash_decode as fd
from dalle_pytorch_tpu_torch.ops import wide_head as wh
from dalle_pytorch_tpu_torch.ops.flash_attention import (
    attention_kernels,
    flash_attention_bwd_plain,
    flash_attention_forward_plain,
    flash_mask,
    on_kernel_head_dim,
)

from test_torch_decode_tile import S_LEN, VARIANTS, _case, _pallas, _t

torch.set_num_threads(2)


@pytest.mark.parametrize("d", [264, 320, 512, 1024])
def test_bf16_above_256_routes_to_the_tensor_core_kernels(d):
    """bf16 at D > 256 names the tensor-core kernels (one fused backward),
    fp32 the CUDA-core ones (two backward kernels), D <= 256 the tuned
    kernels of flash_attention.cu."""
    bf16 = attention_kernels(d, torch.bfloat16)
    assert bf16["fwd"].startswith("wide_fwd_mma_kernel<") and len(bf16["bwd"]) == 1
    assert bf16["bwd"][0].startswith("wide_bwd_mma_kernel<")
    assert bf16["fwd"] == wh.wide_attention_plan(d, "fwd").kernel
    assert attention_kernels(d, torch.float32) == {
        "fwd": "wide_fwd_kernel<float>", "bwd": ("wide_dq_kernel<float>", "wide_dkv_kernel<float>")}
    small = d // 4 if d // 4 <= 256 else 256
    assert attention_kernels(small, torch.bfloat16)["fwd"].startswith("fwd_wgmma_kernel<")
    assert attention_kernels(small, torch.float32)["bwd"][0].startswith("dq_kernel<")
    with pytest.raises(TypeError):
        attention_kernels(d, torch.float16)


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_plans_own_each_column_once_and_fit_shared_memory(kind):
    """At every D in 257..1024: D padded to a multiple of 8, each output
    column owned by exactly one group, no group empty, `groups` as the
    kernel's launcher counts them (ceil(D / cols)), an instance's column
    count, and a block's shared memory within 227 KB; the most re-read
    operand resident up to D = 576 (forward, two blocks an SM) and 640
    (backward), streamed above; every instance some D's plan."""
    used = set()
    for d in range(257, 1025):
        plan = wh.wide_attention_plan(d, kind)
        used.add(plan.cols)
        assert plan.d_kernel % wh.MMA_ALIGN == 0 and 0 <= plan.d_kernel - d < wh.MMA_ALIGN
        owned = np.zeros(plan.d_kernel, int)
        for g in range(plan.groups):
            cols = plan.columns(g)
            assert len(cols) > 0
            owned[cols.start:cols.stop] += 1
        assert (owned == 1).all(), d
        assert plan.groups == -(-plan.d_kernel // plan.cols)
        assert plan.cols in wh.MMA_COLS[kind] and plan.cols <= wh.MMA_MAX_COLS[kind]
        assert plan.chunks == -(-plan.d_kernel // 64)
        assert plan.smem == wh.mma_smem(kind, plan.cols, plan.d_kernel, plan.resident) <= wh.SMEM_LIMIT
        # resident where it fits: the forward two blocks an SM, the backward one
        assert plan.resident == (plan.d_kernel <= {"fwd": 576, "bwd": 640}[kind])
        if kind == "fwd":
            assert 2 * (plan.smem + wh.SMEM_RESERVED) <= wh.SMEM_SM
    assert used == set(wh.MMA_COLS[kind])  # every instance the library builds is reachable
    assert wh.wide_attention_plan(320, kind).groups == {"fwd": 2, "bwd": 3}[kind]
    with pytest.raises(ValueError):
        wh.wide_attention_plan(256, kind)


def _inputs(b, h, n, d, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, h, n, d).astype(np.float32) for _ in range(4))


def _pattern(n):
    return np.tril(np.ones((n, n), bool)) & build_static_mask("axial_row", n - 1, 8, 1)[:n, :n]


@pytest.mark.parametrize("d", [264, 320])
@pytest.mark.parametrize("arm", ["causal", "all", "axial_row"])
def test_tensor_core_arithmetic_matches_the_pallas_kernels(d, arm):
    """The bf16 kernels' arithmetic (plain versions with p_dtype=bfloat16)
    against the Pallas forward and backward (interpret mode, 16 x 16
    tiles, float32) at B = 2, H = 2, N = 80: o, dq, dk and dv within 2^-8 of
    the largest |reference|, lse exactly the plain function's (1e-5)."""
    n = 80
    q, k, v, g = _inputs(2, 2, n, d, seed=d)
    mask = _pattern(n) if arm == "axial_row" else None
    causal = arm != "all"

    def jout(q_, k_, v_):
        return jax_flash_attention(q_, k_, v_, mask=mask, causal=causal, block_q=16, block_k=16,
                                   interpret=True)

    ref, vjp = jax.vjp(jout, *(jnp.asarray(x) for x in (q, k, v)))
    ref_grads = vjp(jnp.asarray(g))
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    fm = None if mask is None else flash_mask(mask)
    o, lse = flash_attention_forward_plain(tq, tk, tv, fm, causal, p_dtype=torch.bfloat16)
    exact_o, exact_lse = flash_attention_forward_plain(tq, tk, tv, fm, causal)
    ref = np.asarray(ref)
    np.testing.assert_allclose(o.numpy(), ref, atol=2**-8 * np.abs(ref).max(), rtol=0)
    np.testing.assert_allclose(exact_o.numpy(), ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, exact_lse, atol=1e-5, rtol=0)
    delta = (tg * o).sum(-1)
    grads = flash_attention_bwd_plain(tq, tk, tv, tg, lse, delta, fm, causal, p_dtype=torch.bfloat16)
    for name, got, jg in zip("qkv", grads, ref_grads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(got.numpy(), jg, atol=2**-8 * np.abs(jg).max(), rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("d", [260, 300])
def test_padding_to_the_kernels_alignment_is_the_unpadded_function(d):
    """bf16 at a D that is not a multiple of 8 reaches the kernels
    zero-padded to one (`wide_kernel_head_dim`, through
    `on_kernel_head_dim`: the true D's scale, outputs cut back); fp32 keeps
    D. Through the plain versions that is the unpadded function (1e-6)."""
    d_kernel = wh.wide_kernel_head_dim(d, torch.bfloat16)
    assert d_kernel == d + (-d) % 8 == wh.wide_attention_plan(d, "fwd").d_kernel
    assert wh.wide_kernel_head_dim(d, torch.float32) == d
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 2, 40, d, seed=3))
    o, lse = flash_attention_forward_plain(q, k, v)
    seen = []

    def forward(q_, k_, v_, scale):
        seen.append(q_.shape[-1])
        return flash_attention_forward_plain(q_, k_, v_, sm_scale=scale)

    po, plse = on_kernel_head_dim(forward, (q, k, v), 1, dims=(d_kernel,))
    assert seen == [d_kernel] and po.shape == o.shape
    torch.testing.assert_close(po, o, atol=1e-6, rtol=0)
    torch.testing.assert_close(plse, lse, atol=1e-6, rtol=0)
    delta = (g * o).sum(-1)
    grads = flash_attention_bwd_plain(q, k, v, g, lse, delta)
    padded = on_kernel_head_dim(
        lambda q_, k_, v_, g_, scale: flash_attention_bwd_plain(q_, k_, v_, g_, lse, delta, sm_scale=scale),
        (q, k, v, g), 3, dims=(d_kernel,))
    for got, want in zip(padded, grads):
        assert got.is_contiguous() and got.shape == want.shape
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("d", [264, 320])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("variant", VARIANTS)
def test_split_k_model_above_256_matches_the_pallas_kernels(variant, n, d):
    """The split-K decode step at D > 256 (`wide_split_kernel`, n <= 4):
    its arithmetic, `flash_decode_split_plain` with spans of DECODE_SPAN =
    128 keys merged in span order, against the Pallas kernel of each
    decode variant (plain, block-sparse, paged, block-sparse paged, each
    with its int8 arm) in interpret mode, float32: a 200-position cache in
    two spans, one row inside its first span, and a bitmap that leaves
    row 2's first span with no visible key (its pages 0-3, or blocks 0-3,
    dead). 2e-5."""
    assert fd.decode_arm(n, torch.float32, d) == "wide_split"
    q, k, v, ks, vs, bm, table, pools = _case(variant, n, d, seed=d + n)
    lengths = np.asarray([n + 2, 150, S_LEN], np.int32)
    if bm is not None:
        bm[:2, 0] = 1  # rows 0 and 1 see a key in span 0
        bm[2, :4] = 0  # row 2: no visible key before position 160 (pages) or 128 (blocks)
        bm[2, 4:] = 1
    ref = np.asarray(_pallas(variant, q, k, v, ks, vs, lengths, bm, table, pools, torch.float32))
    paged = "paged" in variant
    kk, vv, sk, sv = pools if paged else (k, v, ks, vs)
    out = fd.flash_decode_split_plain(
        _t(q), _t(kk), _t(vv), _t(lengths), _t(sk), _t(sv), block_bitmap=_t(bm),
        block_k=None if paged else 32, page_table=_t(table), span=fd.DECODE_SPAN,
    )
    assert out.shape == q.shape and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("dtype,multi_row", [(torch.float32, "wide"), (torch.bfloat16, "wide_tile")])
def test_split_k_takes_the_step_up_to_1024_channels(dtype, multi_row):
    """The split-K kernel takes n <= WIDE_SPLIT_ROWS (= DECODE_ROWS) rows at
    257..1024 channels in either dtype; n > 4 takes the multi-row arm of
    q's dtype (the tensor-core tile kernel for bf16, the 4-row kernel for
    fp32) and wider heads at the step keep the 4-row kernel, as
    `decode_arm` names them; its spans are flash_decode's."""
    assert wh.WIDE_SPLIT_ROWS == fd.DECODE_ROWS == 4 and wh.WIDE_SPLIT_MAX_D == 1024
    assert all(wh.wide_split_takes(n, d) for n in (1, 4) for d in (257, 320, 512, 1024))
    assert not any(wh.wide_split_takes(n, d) for n, d in ((5, 320), (1, 1025)))
    assert [fd.decode_arm(n, dtype, 512) for n in (1, 2, 4, 5, 1280)] == [
        "wide_split"] * 3 + [multi_row] * 2
    assert fd.decode_arm(1, dtype, 2048) == "wide"


def test_cpu_decode_above_256_counts_no_wide_launch():
    """On CPU tensors the decode wrappers run their plain versions at D >
    256, counting no launch of either wide decode kernel."""
    q, k, v, _, _, _, _, _ = _case("plain", 1, 320, seed=1)
    lengths = _t(np.asarray([3, 150, S_LEN], np.int32))
    before = (wh.wide_decode.launches, wh.wide_decode.split_launches)
    out = fd.flash_decode_attention(_t(q), _t(k), _t(v), lengths)
    assert torch.equal(out, fd.flash_decode_attention_plain(_t(q), _t(k), _t(v), lengths))
    assert (wh.wide_decode.launches, wh.wide_decode.split_launches) == before
