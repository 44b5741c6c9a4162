"""The float32 flash-attention backward's TF32 split: its rounding, its
split, and the plain model of the kernels' arithmetic against the JAX
package's Pallas kernels.

On the card the float32 backward at D <= 256 forms every product as three
TF32 tensor-core products of operands split into (hi, lo)
(`csrc/flash_attention.cu`: `dq_tf32_kernel`, `dkv_tf32_kernel`).
`flash_attention_bwd_tf32x3_plain` is that arithmetic in PyTorch; here it
runs on the CPU against `jax.vjp` through `ops/pallas_attention.py:
flash_attention` (Pallas interpret mode, 16 x 16 tiles) and against the
exact plain backward. The kernels themselves are held to the exact plain
version on the card by `chip_smoke.py`.

Tolerances: against JAX 1e-4 absolute, as `test_bwd_plain_matches_jax_grad`
holds the exact plain backward (float32 sums in other orders); the split
against the exact version 2e-5 absolute at these sizes (a product keeps
~21 of float32's 24 bits: ~2^-21 relative a term, over sums of at most 64
terms of size ~1 at most 8 apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.ops.pallas_attention import flash_attention as jax_flash_attention
from dalle_pytorch_tpu_torch.models.transformer import build_static_mask
from dalle_pytorch_tpu_torch.ops.flash_attention import (
    attention_kernels,
    flash_attention_bwd_plain,
    flash_attention_bwd_tf32x3_plain,
    flash_attention_forward_plain,
    round_tf32,
    split_tf32,
    tf32x3_matmul,
)
from dalle_pytorch_tpu_torch.ops.wide_head import wide_fp32_plan

torch.set_num_threads(2)


def _bits(x: int) -> torch.Tensor:
    return torch.tensor([x], dtype=torch.int64).to(torch.int32).view(torch.float32)


def _as_bits(x: torch.Tensor) -> int:
    return int(x.view(torch.int32).item()) & 0xFFFFFFFF


# (input bits, rounded bits): TF32 keeps the sign, the 8 exponent bits and
# the top 10 of the 23 mantissa bits; the 13 below round to nearest, ties
# away from zero
ROUNDING = {
    "exact": (0x3F800000, 0x3F800000),                  # 1.0
    "below_half": (0x3F800FFF, 0x3F800000),             # 1 + (2^12 - 1) 2^-23: down
    "tie_up": (0x3F801000, 0x3F802000),                 # 1 + 2^-11: a tie, away from zero
    "tie_odd": (0x3F803000, 0x3F804000),                # 1 + 3 * 2^-11: a tie, away from zero (not to even)
    "above_half": (0x3F801001, 0x3F802000),
    "negative_tie": (0xBF801000, 0xBF802000),           # -(1 + 2^-11): away from zero, more negative
    "negative_down": (0xBF800FFF, 0xBF800000),
    "carry_into_exponent": (0x3FFFF000, 0x40000000),    # 2 - 2^-11 rounds to 2.0
    "largest_finite": (0x7F7FFFFF, 0x7F800000),         # past the largest TF32: infinity
    "largest_tf32": (0x7F7FE000, 0x7F7FE000),
    "subnormal_down": (0x00000FFF, 0x00000000),
    "subnormal_tie": (0x00001000, 0x00002000),
    "subnormal_to_normal": (0x007FF000, 0x00800000),   # carries into the smallest normal
    "negative_subnormal": (0x80001800, 0x80002000),
    "negative_zero": (0x80000000, 0x80000000),
    "plus_infinity": (0x7F800000, 0x7F800000),
    "minus_infinity": (0xFF800000, 0xFF800000),
}


@pytest.mark.parametrize("case", list(ROUNDING))
def test_round_tf32_bit_patterns(case):
    """round_tf32 on hand-picked float32 bit patterns: ties, negatives,
    subnormals, the exponent carry, the overflow to infinity, infinities."""
    x, want = ROUNDING[case]
    assert _as_bits(round_tf32(_bits(x))) == want


@pytest.mark.parametrize("payload", [0x7FC00000, 0x7F800001, 0xFFFFFFFF, 0x7F801FFF])
def test_round_tf32_keeps_nan(payload):
    """NaN stays NaN, whatever its payload (a payload only in the dropped
    bits must not round to infinity)."""
    assert torch.isnan(round_tf32(_bits(payload))).all()


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 1e4, 1e30])
def test_split_reproduces_x(scale):
    """hi and lo are TF32 values (13 low bits clear) and hi + lo equals x
    within 2^-22 relative, at any magnitude."""
    x = torch.from_numpy(np.random.RandomState(3).randn(4096).astype(np.float32)) * scale
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max().item()
    assert rel <= 2.0**-22


def test_tf32x3_matmul_keeps_about_21_bits():
    """The three-product matmul is within 2^-20 of the float64 product per
    unit of sum |a||b| (TF32 alone, one product, is ~2^-11)."""
    rng = np.random.RandomState(4)
    a, b = (torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in ((64, 96), (96, 48)))
    exact = a.double() @ b.double()
    size = a.double().abs() @ b.double().abs()
    err = ((tf32x3_matmul(a, b).double() - exact).abs() / size).max().item()
    one = ((round_tf32(a).double() @ round_tf32(b).double() - exact).abs() / size).max().item()
    assert err <= 2.0**-20 and one > 2.0**-14


def _inputs(n_q, n_k, d, seed):
    rng = np.random.RandomState(seed)
    return tuple(
        rng.randn(*shape).astype(np.float32)
        for shape in ((2, 2, n_q, d), (2, 2, n_k, d), (2, 2, n_k, d), (2, 2, n_q, d))
    )


def _axial_row_mask():
    return np.tril(np.ones((40, 40), bool)) & build_static_mask("axial_row", 39, 6, layer_ind=3)[:40, :40]


CASES = {
    "causal_d16": (40, 40, 16, True, None),
    "causal_d48": (40, 40, 48, True, None),
    "causal_d64": (40, 40, 64, True, None),
    "nk>nq_d16": (24, 40, 16, True, None),
    "nk>nq_d64": (24, 40, 64, True, None),
    "axial_row_d48": (40, 40, 48, True, "axial_row"),
    "no_mask_d64": (40, 40, 64, False, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_split_backward_matches_jax_grad(case):
    """The split model's (dq, dk, dv), from the plain forward's lse and
    delta, equal jax.vjp through the JAX flash_attention (Pallas interpret
    mode) to 1e-4: causal, n_k > n_q, a static pattern, no mask; D = 16,
    48, 64."""
    n_q, n_k, d, causal, pattern = CASES[case]
    q, k, v, g = _inputs(n_q, n_k, d, seed=21)
    mask = None if pattern is None else _axial_row_mask()

    def jout(q_, k_, v_):
        return jax_flash_attention(
            q_, k_, v_, mask=mask, causal=causal, block_q=16, block_k=16, interpret=True
        )

    _, vjp = jax.vjp(jout, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    o, lse = flash_attention_forward_plain(tq, tk, tv, mask, causal)
    delta = (tg * o).sum(-1)
    grads = flash_attention_bwd_tf32x3_plain(tq, tk, tv, tg, lse, delta, mask, causal)
    for name, got, jg in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(jg), atol=1e-4, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("case", list(CASES))
def test_split_backward_against_the_exact_plain_version(case):
    """The split model against `flash_attention_bwd_plain` (float32
    products) on the same inputs: within 2e-5, and not equal (the split
    does change the arithmetic)."""
    n_q, n_k, d, causal, pattern = CASES[case]
    tq, tk, tv, tg = (torch.from_numpy(x) for x in _inputs(n_q, n_k, d, seed=22))
    mask = None if pattern is None else _axial_row_mask()
    o, lse = flash_attention_forward_plain(tq, tk, tv, mask, causal)
    delta = (tg * o).sum(-1)
    split = flash_attention_bwd_tf32x3_plain(tq, tk, tv, tg, lse, delta, mask, causal)
    exact = flash_attention_bwd_plain(tq, tk, tv, tg, lse, delta, mask, causal)
    worst = max((a - b).abs().max().item() for a, b in zip(split, exact))
    assert 0.0 < worst <= 2e-5


@pytest.mark.parametrize("d", [8, 16, 48, 64, 100, 128, 200, 256])
def test_fp32_backward_routes_to_the_tf32_kernels(d):
    """At D <= 256 the float32 backward names the two TF32 passes at the
    instance D pads to; above 256 the wide register-tiled passes."""
    kd = next(x for x in (16, 32, 64, 128, 256) if d <= x)
    assert attention_kernels(d, torch.float32)["bwd"] == (f"dq_tf32_kernel<{kd}>", f"dkv_tf32_kernel<{kd}>")


@pytest.mark.parametrize("d", [264, 320, 512])
def test_fp32_backward_above_256_keeps_the_wide_kernels(d):
    cols = wide_fp32_plan(d, "dq").cols
    assert attention_kernels(d, torch.float32)["bwd"] == (
        f"wide_dq_fma_kernel<{cols}>", f"wide_dkv_fma_kernel<{cols}>")
