"""The multi-row decode above head dim 256 on the CPU: the tensor-core tile
kernel of `csrc/wide_decode_tile.cu`, which the card runs for bf16 q at n
> DECODE_ROWS query rows and D > 256 (the prefill chunk and the resume
forward of a model with wide heads).

Its arithmetic is the tile arm's at any D (`flash_decode_tile_plain`:
64-key tiles in order, S scaled in fp32, P in base 2 multiplied into V as
the bf16 pair hi = bf16(P), lo = bf16(P - hi), int8 K/V as integers with
the scales on S's and P's columns, keys no row reads zeroed); the kernel
differs from it only in the fp32 summation order of S over 64-channel
chunks. Here that model meets the JAX package's Pallas decode kernels, in
interpret mode as the JAX tests run them, for every decode variant at D =
264 and 320, and the launch plan (column groups, residency, shared
memory) is checked at every D from 257 to 1024. The kernel itself is held
against the plain version and this model on the card by `chip_smoke.py`
(phase 2, `check_wide_decode`).

Tolerances: bf16 inputs 2^-7 * max(1, max |ref|), `chip_smoke.py`'s
`decode_tol` for the card's decode kernels (the model rounds the output
to bf16, as the Pallas kernel does); P's precision P_PAIR_RMS, as
`test_torch_decode_tile.py` holds it at D <= 256.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch.ops import flash_decode as fd
from dalle_pytorch_tpu_torch.ops import wide_head as wh

from test_torch_decode_tile import P_PAIR_RMS, VARIANTS, _case, _hold, _lengths, _pallas, _t, _visible_rows

torch.set_num_threads(2)

ROWS = [5, 65]
DIMS = [264, 320]


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_wide_tile_model_matches_the_pallas_kernels(variant, n):
    """The tile model at D > 256 against the Pallas kernel of each decode
    variant (rows 1-5 of the kernel table, both arms), bf16 inputs under
    decode_tol: n = 5 (a row that sees one key, rows that see none) and 65
    (two 64-row query tiles) over a 200-position cache, a random bitmap
    with dead blocks and a shuffled page table; each variant meets D = 264
    and 320 across its two n."""
    d = DIMS[(VARIANTS.index(variant) + ROWS.index(n)) % len(DIMS)]
    assert fd.decode_arm(n, torch.bfloat16, d) == "wide_tile"
    _hold(variant, n, d, torch.bfloat16, seed=11 * n + d)


@pytest.mark.parametrize("n,d,seed", [(130, 320, 9), (65, 264, 4)])
def test_wide_tile_model_carries_p_as_the_reference_does(n, d, seed):
    """P's precision at D > 256, as at D <= 256: against the Pallas kernel
    in interpret mode (fp32 P into the upcast V), bf16 inputs, the rms of
    the difference over the rows that see a key stays within P_PAIR_RMS =
    1e-4 with P as the bf16 pair the kernel multiplies, and not with one
    bf16 P."""
    q, k, v, ks, vs, bm, table, pools = _case("plain", n, d, seed)
    lengths = _lengths(n)
    ref = np.asarray(_pallas("plain", q, k, v, ks, vs, lengths, bm, table, pools, torch.bfloat16)
                     .astype(jnp.float32))
    mask = np.broadcast_to(_visible_rows("plain", n, lengths, bm)[:, None, :, None], ref.shape)
    args = (_t(q, torch.bfloat16), _t(k, torch.bfloat16), _t(v, torch.bfloat16), _t(lengths))

    def rms():
        diff = (fd.flash_decode_tile_plain(*args).float().numpy() - ref)[mask]
        return float(np.sqrt((diff**2).mean()))

    pair = rms()
    one_p = fd._p_operands
    try:
        fd._p_operands = lambda p, dtype: (p.to(dtype).float(),)
        single = rms()
    finally:
        fd._p_operands = one_p
    assert pair <= P_PAIR_RMS < single, (pair, single)


@pytest.mark.parametrize("quant", [False, True])
def test_wide_tile_plans_own_each_column_once_and_fit_shared_memory(quant):
    """The decode tile kernel's plan at every D in 257..1024 (no padding:
    the kernel zero-fills the channels past D): each output column owned
    by exactly one group of the instance's column count, `groups` as the
    kernel's launcher counts them (ceil(D / cols)), the shared memory
    within 227 KB and Q resident exactly where two blocks still fit an SM
    (bf16 up to D = 576, int8 up to 512); D above 1024 streams Q and still
    fits (no upper limit)."""
    for d in range(257, 1025):
        plan = wh.wide_tile_plan(d, quant)
        assert plan.d_kernel == d and plan.cols == wh.TILE_COLS
        owned = np.zeros(d, int)
        for g in range(plan.groups):
            cols = plan.columns(g)
            assert len(cols) > 0
            owned[cols.start:cols.stop] += 1
        assert (owned == 1).all(), d
        assert plan.groups == -(-d // plan.cols) and plan.chunks == -(-d // 64)
        assert plan.smem == wh.wide_tile_smem(d, plan.resident, quant) <= wh.SMEM_LIMIT
        assert plan.resident == (d <= (512 if quant else 576))
        assert 2 * (plan.smem + wh.TILE_STATIC_SMEM + wh.SMEM_RESERVED) <= wh.SMEM_SM
    assert wh.wide_tile_plan(320, quant).groups == 2 and wh.wide_tile_plan(512, quant).groups == 3
    for d in (2048, 4096):
        plan = wh.wide_tile_plan(d, quant)
        assert not plan.resident and plan.cols == 192 and plan.smem <= wh.SMEM_LIMIT


def test_wide_tile_is_the_multi_row_arm_above_256_and_cpu_calls_count_no_launch():
    """bf16 q above DECODE_ROWS rows at any D > 256 names the tile kernel
    ("wide_tile"); fp32 q there runs `wide_decode_fma_kernel`
    ("wide_tile_f32"); the step keeps split-K. On CPU tensors the wrappers
    run their plain versions and count no launch of any wide decode
    kernel."""
    bf, f32 = torch.bfloat16, torch.float32
    for d in (257, 264, 300, 320, 512, 1024, 2048):
        assert [fd.decode_arm(n, bf, d) for n in (5, 65, 257, 1280)] == ["wide_tile"] * 4
        assert [fd.decode_arm(n, f32, d) for n in (5, 1280)] == ["wide_tile_f32"] * 2
        assert wh.wide_tile_takes(5, bf) and not wh.wide_tile_takes(4, bf)
        assert not wh.wide_tile_takes(5, f32)
    assert fd.decode_arm(4, bf, 320) == "wide_split"
    q, k, v, _, _, bm, table, pools = _case("block_sparse_paged", 65, 320, seed=2)
    tq, tk, tv = (_t(x, bf) for x in (q, k, v))
    kp, vp = (_t(x, bf) for x in pools[:2])
    lengths = _t(_lengths(65))
    counters = (wh.wide_decode.launches, wh.wide_decode.split_launches, wh.wide_decode.tile_launches)
    outs = [
        fd.flash_decode_attention(tq, tk, tv, lengths),
        fd.block_sparse_flash_decode_attention(tq, tk, tv, lengths, _t(np.ones((3, 7), np.int32)), 32),
        fd.paged_flash_decode_attention(tq, kp, vp, lengths, _t(table)),
        fd.block_sparse_paged_flash_decode_attention(tq, kp, vp, lengths, _t(table), _t(bm)),
    ]
    assert all(o.shape == tq.shape and o.dtype == bf for o in outs)
    assert torch.equal(outs[0], fd.flash_decode_attention_plain(tq, tk, tv, lengths))
    assert (wh.wide_decode.launches, wh.wide_decode.split_launches, wh.wide_decode.tile_launches) == counters
