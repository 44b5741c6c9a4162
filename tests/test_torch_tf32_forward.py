"""The float32 flash-attention forward's TF32 split: the plain model of the
kernel's arithmetic against the JAX package's Pallas kernel and against
the exact plain forward, and which kernel the forward names.

On the card the float32 forward at D <= 256 forms S = Q K^T and each key
tile's P V as three TF32 tensor-core products of operands split into (hi,
lo), with the online softmax in base 2 per 64-key tile
(`csrc/flash_attention.cu`: `fwd_tf32_kernel`).
`flash_attention_forward_tf32x3_plain` is that arithmetic in PyTorch; here
it runs on the CPU against the JAX package's `flash_attention` (its o) and
`_flash_forward` (its lse) in Pallas interpret mode with 16 x 16 tiles,
and against the exact plain forward. The kernel itself is held to the
exact plain version and to this model on the card by `chip_smoke.py`.

Tolerances: against JAX 1e-4 absolute, as the backward's split model is
held (`tests/test_torch_tf32_backward.py`: float32 sums in other orders);
the split against the exact version 2e-5 absolute at these sizes (a
product keeps ~21 of float32's 24 bits: ~2^-21 relative a term, over sums
of at most 64 terms of size ~1 at most 8 apart).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.ops.pallas_attention import _flash_forward, _pad_to
from dalle_pytorch_tpu.ops.pallas_attention import flash_attention as jax_flash_attention
from dalle_pytorch_tpu.ops.pallas_attention import mask_block_layout as jax_mask_block_layout
from dalle_pytorch_tpu_torch.models.transformer import build_static_mask
from dalle_pytorch_tpu_torch.ops.flash_attention import (
    attention_kernels,
    flash_attention_fwd,
    flash_attention_forward_plain,
    flash_attention_forward_tf32x3_plain,
)
from dalle_pytorch_tpu_torch.ops.wide_head import wide_fp32_plan

torch.set_num_threads(2)

TILE = 16  # the Pallas kernel's query and key tiles here


def _inputs(n_q, n_k, d, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*shape).astype(np.float32) for shape in ((2, 2, n_q, d), (2, 2, n_k, d), (2, 2, n_k, d)))


def _axial_row_mask():
    return np.tril(np.ones((40, 40), bool)) & build_static_mask("axial_row", 39, 6, layer_ind=3)[:40, :40]


def _jax_lse(q, k, v, mask, causal):
    """The Pallas forward's lse [B, H, n_q], padded and masked as the JAX
    package's `flash_attention` pads and masks before its kernel."""
    n_q, n_k, d = q.shape[2], k.shape[2], q.shape[3]
    if mask is not None:
        mask_pad, layout = (jnp.asarray(x) for x in jax_mask_block_layout(mask, TILE, TILE))
    else:
        mask_pad = layout = None
    _, lse = _flash_forward(
        *(_pad_to(jnp.asarray(x), 2, TILE) for x in (q, k, v)), mask_pad, layout,
        sm_scale=d**-0.5, block_q=TILE, block_k=TILE, causal=causal and mask is None,
        n_real_q=n_q, n_real_k=n_k, interpret=True,
    )
    return np.asarray(lse)[:, :, :n_q, 0]


CASES = {
    "causal_d16": (40, 40, 16, True, None),
    "causal_d48": (40, 40, 48, True, None),
    "causal_d64": (40, 40, 64, True, None),
    "nk>nq_d16": (24, 40, 16, True, None),
    "nk>nq_d64": (24, 40, 64, True, None),
    "nk>nq_d48": (24, 70, 48, True, None),
    "axial_row_d16": (40, 40, 16, True, "axial_row"),
    "axial_row_d48": (40, 40, 48, True, "axial_row"),
    "axial_row_d64": (40, 40, 64, True, "axial_row"),
    "no_mask_d16": (40, 40, 16, False, None),
    "no_mask_d48": (24, 70, 48, False, None),
    "no_mask_d64": (40, 40, 64, False, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_split_forward_matches_the_pallas_kernel(case):
    """The split model's o and lse equal the JAX flash attention's (Pallas
    interpret mode, 16 x 16 tiles) to 1e-4: causal, n_k > n_q, a static
    pattern, no mask; D = 16, 48, 64."""
    n_q, n_k, d, causal, pattern = CASES[case]
    q, k, v = _inputs(n_q, n_k, d, seed=31)
    mask = None if pattern is None else _axial_row_mask()
    jout = jax_flash_attention(*(jnp.asarray(x) for x in (q, k, v)), mask=mask, causal=causal,
                               block_q=TILE, block_k=TILE, interpret=True)
    o, lse = flash_attention_forward_tf32x3_plain(*(torch.from_numpy(x) for x in (q, k, v)), mask, causal)
    assert o.dtype == lse.dtype == torch.float32 and lse.shape == (2, 2, n_q)
    np.testing.assert_allclose(o.numpy(), np.asarray(jout), atol=1e-4, rtol=0, err_msg="o")
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, v, mask, causal), atol=1e-4, rtol=0, err_msg="lse")


@pytest.mark.parametrize("case", list(CASES))
def test_split_forward_against_the_exact_plain_version(case):
    """The split model against `flash_attention_forward_plain` (float32
    products) on the same inputs: within 2e-5, and not equal (the split
    does change the arithmetic)."""
    n_q, n_k, d, causal, pattern = CASES[case]
    tq, tk, tv = (torch.from_numpy(x) for x in _inputs(n_q, n_k, d, seed=32))
    mask = None if pattern is None else _axial_row_mask()
    split = flash_attention_forward_tf32x3_plain(tq, tk, tv, mask, causal)
    exact = flash_attention_forward_plain(tq, tk, tv, mask, causal)
    worst = max((a - b).abs().max().item() for a, b in zip(split, exact))
    assert 0.0 < worst <= 2e-5


def test_split_forward_over_several_key_tiles():
    """Past one 64-key tile (n = 150: three tiles, the last ragged) the
    model's per-tile maxima and rescaled partials still give the exact
    forward within 2e-5, causal and not."""
    tq, tk, tv = (torch.from_numpy(x) for x in _inputs(150, 150, 32, seed=33))
    for causal in (True, False):
        split = flash_attention_forward_tf32x3_plain(tq, tk, tv, None, causal)
        exact = flash_attention_forward_plain(tq, tk, tv, None, causal)
        assert max((a - b).abs().max().item() for a, b in zip(split, exact)) <= 2e-5


def test_cpu_forward_runs_the_exact_plain_version():
    """On CPU tensors `flash_attention_fwd` runs the exact plain version
    (not the split's model) and counts no launch."""
    tq, tk, tv = (torch.from_numpy(x) for x in _inputs(40, 40, 48, seed=34))
    before = flash_attention_fwd.launches
    o, lse = flash_attention_fwd(tq, tk, tv)
    ref = flash_attention_forward_plain(tq, tk, tv)
    assert torch.equal(o, ref[0]) and torch.equal(lse, ref[1])
    assert flash_attention_fwd.launches == before


@pytest.mark.parametrize("d", [8, 16, 48, 64, 100, 128, 200, 256])
def test_fp32_forward_routes_to_the_tf32_kernel(d):
    """At D <= 256 the float32 forward names the TF32 tensor-core kernel at
    the instance D pads to (the bfloat16 one keeps the wgmma kernel)."""
    kd = next(x for x in (16, 32, 64, 128, 256) if d <= x)
    assert attention_kernels(d, torch.float32)["fwd"] == f"fwd_tf32_kernel<{kd}>"
    assert attention_kernels(d, torch.bfloat16)["fwd"].startswith("fwd_wgmma_kernel<")


@pytest.mark.parametrize("d", [264, 320, 512])
def test_fp32_forward_above_256_keeps_the_wide_kernel(d):
    assert attention_kernels(d, torch.float32)["fwd"] == f"wide_fwd_fma_kernel<{wide_fp32_plan(d, 'fwd').cols}>"
