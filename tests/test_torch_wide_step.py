"""The decode step above 1024 channels on the CPU: routing, the split-K
kernel's launch plan at every head dim it distinguishes, and the step's
function against the JAX package's Pallas decode kernels.

On the card every decode call of n <= 4 query rows above 256 channels runs
the split-K kernel `wide_split_kernel` (`csrc/wide_head.cu`): 2 chunks of
4 output columns a thread up to 1024 channels, 8 above, one column group
up to 4096 channels and groups of 4096 above (each forming the whole
scores from K in 4096-channel pieces). `ops/wide_head.py:wide_split_plan`
is its plan, which the kernel's launcher checks. Here the port's decode
wrappers (their plain versions, on CPU tensors) and the split-K
arithmetic's model `flash_decode_split_plain` meet the Pallas kernels in
interpret mode at D = 1032 (the wide instance, one group) and D = 4104
(the widest instance's columns plus 8: two groups), tiny B, H and S.

Tolerances, those of `tests/test_torch_wide_head.py` and
`tests/test_torch_decode_tile.py`: float32 2e-5 absolute (summation
order); bfloat16 2^-7 * max(1, max |ref|) (`chip_smoke.py`'s
`decode_tol`: both round one float32 result to bf16).
"""

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch.ops import flash_decode as fd
from dalle_pytorch_tpu_torch.ops import wide_head as wh

from test_torch_decode_tile import S_LEN, _case, _pallas, _t

torch.set_num_threads(2)

SMEM_LIMIT = 232448  # a block's shared memory on the H100 (227 KB)
WIDEST = wh.SPLIT_CHUNKS[-1] * 4 * wh.SPLIT_THREADS  # the wide instance's columns: 4096
STEP_DIMS = (1032, WIDEST + 8)


def _port(variant, q, k, v, ks, vs, lengths, bm, table, pools, dtype):
    """The port's decode wrapper of `variant` on CPU tensors in `dtype`."""
    paged = "paged" in variant
    kk, vv, sk, sv = pools if paged else (k, v, ks, vs)
    args = (_t(q, dtype), _t(kk, dtype), _t(vv, dtype), _t(lengths))
    sc = () if sk is None else (_t(sk), _t(sv))
    if paged and bm is not None:
        return fd.block_sparse_paged_flash_decode_attention(*args, _t(table), _t(bm), *sc)
    if paged:
        return fd.paged_flash_decode_attention(*args, _t(table), *sc)
    if bm is not None:
        return fd.block_sparse_flash_decode_attention(*args, _t(bm), 32, *sc)
    return fd.flash_decode_attention(*args, *sc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", STEP_DIMS)
@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("variant", ["plain", "int8", "block_sparse", "paged_int8", "block_sparse_paged"])
def test_step_above_1024_matches_the_pallas_kernels(variant, n, d, dtype):
    """The step above 1024 channels through the port's wrappers, and in
    float32 also the split-K model (spans of DECODE_SPAN keys merged in
    span order), against the Pallas kernel of the variant: a 200-position
    cache in two spans, one row inside its first span, a bitmap that
    leaves row 2's first span without a visible key."""
    assert fd.decode_arm(n, dtype, d) == "wide_split"
    q, k, v, ks, vs, bm, table, pools = _case(variant, n, d, seed=d + n)
    lengths = np.asarray([n + 2, 150, S_LEN], np.int32)
    if bm is not None:
        bm[:2, 0] = 1  # rows 0 and 1 see a key in span 0
        bm[2, :4] = 0  # row 2: no visible key before position 160 (pages) or 128 (blocks)
        bm[2, 4:] = 1
    ref = np.asarray(_pallas(variant, q, k, v, ks, vs, lengths, bm, table, pools, dtype)).astype(np.float32)
    tol = 2e-5 if dtype == torch.float32 else 2.0**-7 * max(1.0, float(np.abs(ref).max()))
    out = _port(variant, q, k, v, ks, vs, lengths, bm, table, pools, dtype)
    assert out.shape == q.shape and out.dtype == dtype and torch.isfinite(out).all()
    np.testing.assert_allclose(out.float().numpy(), ref, atol=tol, rtol=0)
    if dtype == torch.float32:
        paged = "paged" in variant
        kk, vv, sk, sv = pools if paged else (k, v, ks, vs)
        model = fd.flash_decode_split_plain(
            _t(q), _t(kk), _t(vv), _t(lengths), _t(sk), _t(sv), block_bitmap=_t(bm),
            block_k=None if paged else 32, page_table=_t(table), span=fd.DECODE_SPAN)
        np.testing.assert_allclose(model.numpy(), ref, atol=tol, rtol=0)


@pytest.mark.parametrize("elt", [1, 2, 4], ids=["int8", "bf16", "fp32"])
@pytest.mark.parametrize("rows", [1, wh.WIDE_SPLIT_ROWS])
def test_split_plan_at_every_head_dim_fits_and_owns_each_column_once(elt, rows):
    """At every D from 257 to WIDEST + 8: the narrow instance (2 chunks) up
    to SPLIT_NARROW_D channels and the wide one (8) above; one column group
    up to WIDEST channels, then ceil(D / WIDEST), each output column owned
    by one group; a staged piece of all of D in one group and WIDEST
    channels above; the largest power of two of keys whose K and V rows
    fit SPLIT_STAGE_BYTES (one key at least); a block's shared memory
    (dynamic and static) within the H100's 227 KB; and every distinct plan
    seen."""
    plans = set()
    for d in range(257, WIDEST + 9):
        plan = wh.wide_split_plan(d, elt, rows)
        plans.add(plan[1:])
        assert plan.chunks == (2 if d <= wh.SPLIT_NARROW_D else 8)
        cols = plan.chunks * 4 * wh.SPLIT_THREADS
        assert plan.groups == -(-d // cols) and (plan.groups == 1) == (d <= WIDEST)
        assert plan.piece == (d if plan.groups == 1 else WIDEST)
        owned = np.zeros(d, int)
        for g in range(plan.groups):
            assert len(plan.columns(g)) > 0
            owned[plan.columns(g)] += 1
        assert (owned == 1).all()
        stride = -(-(-(-plan.piece // 8) * 8 * elt) // 16) * 16
        keys = plan.tile_keys
        assert keys & (keys - 1) == 0 and 1 <= keys <= wh.SPLIT_KEYS
        assert keys == 1 or 2 * keys * stride <= wh.SPLIT_STAGE_BYTES
        assert keys == wh.SPLIT_KEYS or 4 * keys * stride > wh.SPLIT_STAGE_BYTES
        assert plan.smem + wh.SPLIT_STATIC_SMEM <= SMEM_LIMIT
    assert {(p[0], p[1]) for p in plans} == {(2, 1), (8, 1), (8, 2)}  # chunks, groups


def test_the_plan_at_the_timed_step():
    """At D = 1032 (chip_smoke's WIDE_STEP_DIM) the wide instance in one
    group: 4 keys a tile in bf16 and 2 in fp32 (a stage's 32 KB), 8 in
    int8; 512 columns a block below 1025 channels."""
    assert [wh.wide_split_plan(1032, elt).tile_keys for elt in (1, 2, 4)] == [8, 4, 2]
    assert wh.wide_split_plan(1032, 2)[1:3] == (8, 1)
    assert wh.wide_split_plan(1024, 2)[1:4] == (2, 1, 1024) and wh.wide_split_plan(1024, 2).tile_keys == 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1025, 1032, 2048, WIDEST, WIDEST + 8, 3 * WIDEST])
def test_every_step_above_1024_names_split_k(d, dtype):
    """`wide_arm` (and `decode_arm`) name the split-K kernel for n <= 4 at
    every width above 1024, and the multi-row kernels above 4 rows; the
    plan names the wide instance, in pieces above WIDEST channels."""
    assert [wh.wide_arm(n, dtype, d) for n in (1, 2, 3, 4)] == ["wide_split"] * 4
    assert fd.decode_arm(1, dtype, d) == "wide_split"
    assert wh.wide_arm(5, dtype, d) == ("wide_tile" if dtype == torch.bfloat16 else "wide_tile_f32")
    plan = wh.wide_split_plan(d, 2)
    assert plan.chunks == 8 and (plan.groups > 1) == (d > WIDEST)


def test_cpu_step_above_1024_counts_no_wide_launch():
    """On CPU tensors the step above 1024 channels runs the plain version
    and counts no launch of any wide decode kernel."""
    wd = wh.wide_decode
    counts = (wd.launches, wd.split_launches, wd.tile_launches, wd.tile_f32_launches)
    q, k, v, _, _, _, _, _ = _case("plain", 1, 1032, seed=5)
    lengths = _t(np.asarray([3, 150, S_LEN], np.int32))
    out = fd.flash_decode_attention(_t(q), _t(k), _t(v), lengths)
    assert torch.equal(out, fd.flash_decode_attention_plain(_t(q), _t(k), _t(v), lengths))
    assert (wd.launches, wd.split_launches, wd.tile_launches, wd.tile_f32_launches) == counts
