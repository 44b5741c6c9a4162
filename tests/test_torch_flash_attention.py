"""The port's flash attention (forward and backward) vs the JAX package's
Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions, and the
differentiable `flash_attention` takes its gradients through them. The JAX
side runs `ops/pallas_attention.py:flash_attention` in Pallas interpret
mode with 16 x 16 tiles, so several tiles, the skip logic and a ragged
edge (N = 40) run there. The CUDA kernels are held against the plain
versions on the card by `chip_smoke.py`.

Tolerances (float32 inputs, both sides accumulate in float32): outputs
1e-5 absolute, dq/dk/dv 1e-4 absolute (the two sum in different orders);
the rounding-matched plain backward against its tile loop 1e-6 (the same
roundings, sums in another order).
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.ops.pallas_attention import flash_attention as jax_flash_attention
from dalle_pytorch_tpu.ops.pallas_attention import mask_block_layout as jax_mask_block_layout
from dalle_pytorch_tpu_torch.models.transformer import build_static_mask
from dalle_pytorch_tpu_torch.ops.flash_attention import (
    BLOCK,
    KERNEL_HEAD_DIMS,
    WGMMA_HEAD_DIMS,
    _FlashAttention,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_dkv_plain,
    flash_attention_dq_plain,
    flash_attention_forward_plain,
    flash_attention_fwd,
    flash_mask,
    kernel_head_dim,
    on_kernel_head_dim,
)
from dalle_pytorch_tpu_torch.ops.masks import mask_block_layout

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _inputs(b, h, n_q, n_k, d, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(
        rng.randn(*shape).astype(np.float32)
        for shape in ((b, h, n_q, d), (b, h, n_k, d), (b, h, n_k, d), (b, h, n_q, d))
    )


def _compare(n_q, n_k, d, mask=None, causal=True, seed=0):
    """Output and the VJP of <out, g> for one numpy g, through both."""
    q, k, v, g = _inputs(2, 2, n_q, n_k, d, seed)

    def jloss(q_, k_, v_):
        out = jax_flash_attention(
            q_, k_, v_, mask=mask, causal=causal, block_q=16, block_k=16, interpret=True
        )
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v))
    )
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = flash_attention(tq, tk, tv, mask=mask, causal=causal)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5, rtol=0)
    for name, t, jg in zip("qkv", (tq, tk, tv), jgrads):
        np.testing.assert_allclose(
            t.grad.numpy(), np.asarray(jg), atol=1e-4, rtol=0, err_msg=f"d{name}"
        )


@pytest.mark.parametrize("n", [32, 40])
def test_causal_matches_the_pallas_kernels(n):
    """N = 40 leaves a ragged 8-row edge tile on the JAX side."""
    _compare(n, n, 16)


@pytest.mark.parametrize("d", [8, 48, 192])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "all"])
def test_any_head_dim_matches_the_pallas_kernels(d, causal):
    """Head dims outside the kernels' instances (16, 32, 64, 128, 256; 192
    runs the 256 instance on the card): the forward and the autograd
    backward equal the reference's at any D."""
    _compare(40, 40, d, causal=causal, seed=12)


def test_no_mask_non_causal():
    _compare(40, 40, 32, causal=False, seed=1)


@pytest.mark.parametrize("n_q, n_k", [(24, 40), (40, 24)])
def test_causal_top_left_convention_when_lengths_differ(n_q, n_k):
    """Row i sees keys j <= i in global indices, for n_k > n_q (the tail
    keys are dead for every row) and n_k < n_q."""
    _compare(n_q, n_k, 16, seed=2)


@pytest.mark.parametrize("attn_type", ["axial_row", "axial_col", "conv_like", "sparse"])
def test_static_patterns_match_the_pallas_kernels(attn_type):
    """Each pattern of the model's layers at 4 text + 6x6 image tokens,
    composed with causality as the model composes it."""
    pattern = build_static_mask(attn_type, 39, 6, layer_ind=3)
    mask = np.tril(np.ones((40, 40), bool)) & pattern[:40, :40]
    _compare(40, 40, 16, mask=mask, causal=True, seed=3)


@pytest.mark.parametrize("d", [8, 48, 100, 192])
def test_head_dim_padding_is_the_unpadded_function(d):
    """The card's padding (`on_kernel_head_dim`: D zero-padded to the
    kernel's next head dim, the true D's scale, outputs cut back), run
    through the plain versions, equals the unpadded plain versions: o and
    lse 1e-6, dq/dk/dv 1e-5 (zero columns change only summation order).
    The forward is padded both ways the card pads it: to the next of all
    instances (float32) and of the bfloat16 wgmma kernel's 64, 128 and
    256. Every D <= 256 has an instance to pad to; 264 raises."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 2, 70, 70, d, seed=13))
    assert kernel_head_dim(d) == {8: 16, 48: 64, 100: 128, 192: 256}[d]
    assert kernel_head_dim(d, WGMMA_HEAD_DIMS) == {8: 64, 48: 64, 100: 128, 192: 256}[d]
    for taken in (129, 136, 200, 256):
        assert kernel_head_dim(taken) == kernel_head_dim(taken, WGMMA_HEAD_DIMS) == 256
    o, lse = flash_attention_forward_plain(q, k, v)
    for dims in (KERNEL_HEAD_DIMS, WGMMA_HEAD_DIMS):
        po, plse = on_kernel_head_dim(
            lambda q_, k_, v_, s: flash_attention_forward_plain(q_, k_, v_, sm_scale=s),
            (q, k, v), 1, dims=dims,
        )
        assert po.shape == o.shape and plse.shape == lse.shape
        torch.testing.assert_close(po, o, atol=1e-6, rtol=0)
        torch.testing.assert_close(plse, lse, atol=1e-6, rtol=0)
    delta = (g * o).sum(-1)
    grads = flash_attention_bwd_plain(q, k, v, g, lse, delta)
    padded = on_kernel_head_dim(
        lambda q_, k_, v_, g_, s: flash_attention_bwd_plain(q_, k_, v_, g_, lse, delta, sm_scale=s),
        (q, k, v, g), 3,
    )
    for got, ref in zip(padded, grads):
        assert got.shape == ref.shape and got.is_contiguous()
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    for dims in (KERNEL_HEAD_DIMS, WGMMA_HEAD_DIMS):
        with pytest.raises(ValueError, match="Queue 3"):
            kernel_head_dim(264, dims)


def test_attention_module_at_head_dim_48_matches_the_reference():
    """The port's `Attention(dim=96, heads=2, dim_head=48,
    attn_impl="flash")` against the JAX `Attention` with the same weights:
    output 1e-5 and the input gradient 1e-4, through the flash arm."""
    from dalle_pytorch_tpu.models.attention import Attention as JAttention
    from dalle_pytorch_tpu_torch.models.attention import Attention

    n, dim = 40, 96
    jattn = JAttention(dim=dim, seq_len=n, heads=2, dim_head=48, attn_impl="flash")
    rng = np.random.RandomState(14)
    x, g = rng.randn(2, n, dim).astype(np.float32), rng.randn(2, n, dim).astype(np.float32)
    params = jattn.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    assert jattn._use_flash(n, None)

    def jloss(x_):
        out, _ = jattn.apply({"params": params}, x_)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    attn = Attention(dim, heads=2, dim_head=48, attn_impl="flash")
    with torch.no_grad():
        attn.to_qkv.weight.copy_(torch.from_numpy(np.array(params["to_qkv"]["kernel"]).T))
        attn.to_out.weight.copy_(torch.from_numpy(np.array(params["to_out"]["kernel"]).T))
        attn.to_out.bias.copy_(torch.from_numpy(np.array(params["to_out"]["bias"])))
    assert attn.use_flash(n, None)
    tx = torch.from_numpy(x).requires_grad_()
    out = attn(tx)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad), atol=1e-4, rtol=0)


def test_wrappers_split_as_the_autograd_function_does():
    """The two wrappers, called directly, give the same o/dq/dk/dv as the
    plain versions and a finite lse; the one backward equals the
    per-gradient plain versions."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 2, 37, 37, 32, seed=4))
    o, lse = flash_attention_fwd(q, k, v)
    o_ref, lse_ref = flash_attention_forward_plain(q, k, v)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    assert lse.dtype == torch.float32 and lse.shape == (1, 2, 37)
    delta = (g * o).sum(-1)
    dq, dk, dv = flash_attention_bwd(q, k, v, g, lse, delta)
    for got, ref in zip((dq, dk, dv), flash_attention_bwd_plain(q, k, v, g, lse, delta)):
        assert torch.equal(got, ref)
    torch.testing.assert_close(dq, flash_attention_dq_plain(q, k, v, g, lse, delta), atol=1e-6, rtol=0)
    for got, ref in zip((dk, dv), flash_attention_dkv_plain(q, k, v, g, lse, delta)):
        torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)


def _static_pattern_mask(attn_type):
    pattern = build_static_mask(attn_type, 39, 6, layer_ind=3)
    return np.tril(np.ones((40, 40), bool)) & pattern[:40, :40]


@pytest.mark.parametrize(
    "n_q, n_k, d, causal, pattern",
    [
        (40, 40, 16, True, None),
        (24, 40, 16, True, None),
        (40, 24, 16, True, None),
        (40, 40, 32, False, None),
        (40, 40, 16, True, "axial_row"),
        (40, 40, 16, True, "axial_col"),
        (40, 40, 16, True, "conv_like"),
        (40, 40, 16, True, "sparse"),
    ],
    ids=["causal", "nk>nq", "nq>nk", "no_mask", "axial_row", "axial_col", "conv_like", "sparse"],
)
def test_bwd_plain_matches_jax_grad(n_q, n_k, d, causal, pattern):
    """`flash_attention_bwd_plain`, from the plain forward's lse and delta,
    equals jax.grad through the JAX `flash_attention` (Pallas interpret
    mode, 16 x 16 tiles) to 1e-4, in every arm."""
    q, k, v, g = _inputs(2, 2, n_q, n_k, d, seed=9)
    mask = None if pattern is None else _static_pattern_mask(pattern)

    def jout(q_, k_, v_):
        return jax_flash_attention(
            q_, k_, v_, mask=mask, causal=causal, block_q=16, block_k=16, interpret=True
        )

    _, vjp = jax.vjp(jout, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    o, lse = flash_attention_forward_plain(tq, tk, tv, mask, causal)
    delta = (tg * o).sum(-1)
    grads = flash_attention_bwd_plain(tq, tk, tv, tg, lse, delta, mask, causal)
    for name, got, jg in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(jg), atol=1e-4, rtol=0, err_msg=f"d{name}")


def _tiled_backward(q, k, v, do, lse, delta, keep, scale, p_dtype):
    """The fused kernel's backward written as its loop over 64-key tiles:
    P and dS formed once per tile in float32 and rounded once to
    `p_dtype`, the same rounded dS feeding both dK and dQ."""
    dq = torch.zeros(q.shape, dtype=torch.float32)
    dks, dvs = [], []
    for k0 in range(0, k.shape[2], BLOCK):
        kt, vt = k[..., k0 : k0 + BLOCK, :].float(), v[..., k0 : k0 + BLOCK, :].float()
        s = torch.matmul(q.float(), kt.transpose(-1, -2)) * scale
        p = torch.exp(s - lse[..., None]).masked_fill(~keep[:, k0 : k0 + BLOCK], 0.0)
        dp = torch.matmul(do.float(), vt.transpose(-1, -2))
        ds = (p * (dp - delta[..., None]) * scale).to(p_dtype).float()
        p = p.to(p_dtype).float()
        dq += torch.matmul(ds, kt)
        dks.append(torch.matmul(ds.transpose(-1, -2), q.float()))
        dvs.append(torch.matmul(p.transpose(-1, -2), do.float()))
    return dq, torch.cat(dks, dim=2), torch.cat(dvs, dim=2)


@pytest.mark.parametrize("arm", ["causal", "axial_row"])
def test_rounding_matched_bwd_plain_is_the_fused_loop(arm):
    """With `p_dtype=bfloat16`, `flash_attention_bwd_plain` equals the
    fused kernel's tile loop that rounds dS once for both products (1e-6),
    and the per-gradient plain versions, which round the same float32 dS,
    agree with it; the rounding moves the result off the exact one."""
    n = 150
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 2, n, n, 16, seed=10))
    keep = torch.ones(n, n, dtype=torch.bool).tril()
    mask = None
    if arm == "axial_row":
        keep &= torch.from_numpy(build_static_mask("axial_row", n - 1, 12, layer_ind=1)[:n, :n])
        mask = flash_mask(keep.numpy())
    o, lse = flash_attention_forward_plain(q, k, v, mask)
    delta = (g * o).sum(-1)
    fused = flash_attention_bwd_plain(q, k, v, g, lse, delta, mask, p_dtype=torch.bfloat16)
    loop = _tiled_backward(q, k, v, g, lse, delta, keep, 0.25, torch.bfloat16)
    for name, got, ref in zip("qkv", fused, loop):
        torch.testing.assert_close(got, ref, atol=1e-6, rtol=0, msg=f"d{name}")
    split = (
        flash_attention_dq_plain(q, k, v, g, lse, delta, mask, p_dtype=torch.bfloat16),
        *flash_attention_dkv_plain(q, k, v, g, lse, delta, mask, p_dtype=torch.bfloat16),
    )
    for got, ref in zip(fused, split):
        torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)
    exact = flash_attention_bwd_plain(q, k, v, g, lse, delta, mask)
    assert all(not torch.equal(a, b) for a, b in zip(fused, exact))


def test_autograd_backward_is_one_backward_call(monkeypatch):
    """`_FlashAttention.backward` computes dq, dk and dv with one call of
    the backward wrapper."""
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    calls = []

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return flash_attention_bwd(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention_bwd", counting)
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 2, 20, 20, 16, seed=11))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    (_FlashAttention.apply(q, k, v, None, True, None) * g).sum().backward()
    assert calls == [q.shape]
    assert all(t.grad is not None and t.grad.shape == t.shape for t in (q, k, v))


def _online_forward(q, k, v, keep, scale, p_dtype):
    """The tensor-core forward written as its loop: 64-key tiles, running
    max m and sum l in float32, in base 2 (scores x = s fl(scale log2(e))),
    P = 2^(x - m) rounded to `p_dtype` before P . V, the accumulator
    rescaled by 2^(m_old - m_new)."""
    scale_log2 = float(np.float32(scale) * np.float32(1.4426950408889634))
    s_all = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale_log2
    s_all = s_all.masked_fill(~keep, -1e30)
    m = torch.full(q.shape[:3] + (1,), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32)
    for k0 in range(0, k.shape[2], BLOCK):
        s = s_all[..., k0 : k0 + BLOCK]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(p_dtype).float(), v[..., k0 : k0 + BLOCK, :].float())
        m = m_new
    return acc / l


@pytest.mark.parametrize("arm", ["causal", "axial_row", "ragged"])
def test_rounding_matched_plain_is_the_kernels_online_loop(arm):
    """With `p_dtype`, the plain versions round P and dS where the
    tensor-core kernels do: the forward equals the kernel's loop over
    64-key tiles (1e-6), and every output moves off the exact function by
    no more than bf16's rounding of P (2^-8 relative)."""
    n = {"causal": 150, "axial_row": 150, "ragged": 97}[arm]
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 2, n, n, 16, seed=8))
    keep = torch.ones(n, n, dtype=torch.bool).tril()
    mask = None
    if arm == "axial_row":
        keep &= torch.from_numpy(build_static_mask("axial_row", n - 1, 12, layer_ind=1)[:n, :n])
        mask = flash_mask(keep.numpy())
    exact, lse = flash_attention_forward_plain(q, k, v, mask)
    for p_dtype in (torch.float32, torch.bfloat16):
        o, lse_r = flash_attention_forward_plain(q, k, v, mask, p_dtype=p_dtype)
        loop = _online_forward(q, k, v, keep, 0.25, p_dtype)
        torch.testing.assert_close(o, loop, atol=1e-6, rtol=0)
        assert torch.equal(lse_r, lse)
    assert not torch.equal(o, exact)
    torch.testing.assert_close(o, exact, atol=2**-8 * exact.abs().max().item(), rtol=0)
    delta = (g * exact).sum(-1)
    pairs = [
        (flash_attention_dq_plain(q, k, v, g, lse, delta, mask, p_dtype=pd),) for pd in (None, torch.bfloat16)
    ] + [flash_attention_dkv_plain(q, k, v, g, lse, delta, mask, p_dtype=pd) for pd in (None, torch.bfloat16)]
    for ref, rounded in ((pairs[0], pairs[1]), (pairs[2], pairs[3])):
        for a, b in zip(ref, rounded):
            assert not torch.equal(a, b)
            torch.testing.assert_close(b, a, atol=2**-8 * a.abs().max().item(), rtol=0)


def test_bfloat16_gradients_come_back_in_bfloat16():
    q, k, v, g = (torch.from_numpy(x).bfloat16() for x in _inputs(1, 1, 20, 20, 16, seed=5))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    (flash_attention(q, k, v) * g).sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 for t in (q, k, v))


def test_cpu_wrappers_count_no_launch():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 1, 10, 10, 16, seed=6))
    counters = (flash_attention_fwd, flash_attention_bwd)
    before = [f.launches for f in counters]
    q.requires_grad_()
    (flash_attention(q, k, v) * g).sum().backward()
    assert [f.launches for f in counters] == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 2, 8, 8, 32, seed=7))
    with pytest.raises(TypeError):
        flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        flash_attention_fwd(q, k.bfloat16(), v)
    # a head dim outside the kernels' instances is the reference's function
    q8, k8, v8 = (t[..., :8].contiguous() for t in (q, k, v))
    ref = jax_flash_attention(
        *(jnp.asarray(t.numpy()) for t in (q8, k8, v8)), block_q=16, block_k=16, interpret=True
    )
    np.testing.assert_allclose(flash_attention_fwd(q8, k8, v8)[0].numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q.repeat(1, 1, 1, 2)[..., ::2], k, v)
    with pytest.raises(ValueError, match=r"\[B, H, N_k, D\]"):
        flash_attention_fwd(q, k[:, :1], v[:, :1])
    with pytest.raises(ValueError, match="mask"):
        flash_attention_fwd(q, k, v, mask=np.ones((8, 9), bool))
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, g, lse.double(), lse)
    with pytest.raises(ValueError, match="delta"):
        flash_attention_bwd(q, k, v, g, lse, lse[..., :4].contiguous())
    with pytest.raises(ValueError, match="do must match"):
        flash_attention_bwd(q, k, v, g[:, :, :4].contiguous(), lse, lse)
    with pytest.raises(TypeError):
        flash_attention_bwd(q.bfloat16(), k, v, g, lse, lse)


def test_fully_masked_row_is_rejected():
    mask = np.tril(np.ones((8, 8), bool))
    mask[3] = False
    with pytest.raises(ValueError, match="fully-masked"):
        flash_mask(mask)


def test_layout_is_taken_at_the_kernels_tiles():
    """The port's `mask_block_layout` is the reference's, and the kernels'
    layout is taken at their own 64 x 64 tiles."""
    n = 150
    mask = np.tril(np.ones((n, n), bool)) & build_static_mask("conv_like", n - 1, 8, 0)
    for block_q, block_k in ((16, 16), (64, 64), (128, 32)):
        ours = mask_block_layout(mask, block_q, block_k)
        ref = jax_mask_block_layout(mask, block_q, block_k)
        assert all(np.array_equal(a, b) for a, b in zip(ours, ref))
    fm = flash_mask(mask)
    assert BLOCK == 64 and fm.layout.shape == (3, 3)
    assert np.array_equal(fm.layout.numpy(), mask_block_layout(mask, 64, 64)[1])


def test_import_needs_neither_nvcc_nor_triton():
    """Importing the module and running it on the CPU, backward included,
    builds nothing: a process with no nvcc on PATH and `triton` refused."""
    code = textwrap.dedent(
        """
        import sys
        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] == "triton":
                    raise ImportError("refused: " + name)
        sys.meta_path.insert(0, Refuse())
        import torch
        from dalle_pytorch_tpu_torch import kernels
        from dalle_pytorch_tpu_torch.ops import flash_attention as fa
        q = torch.randn(1, 1, 5, 16, requires_grad=True)
        fa.flash_attention(q, q, q).sum().backward()
        assert kernels.build_log == {} and fa.flash_attention_fwd.launches == 0
        print("ok")
        """
    )
    env = {**os.environ, "PATH": "/usr/bin:/bin", "CUDA_HOME": "/nonexistent"}
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
