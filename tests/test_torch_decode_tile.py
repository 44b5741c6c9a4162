"""Flash decode's tile arm (`csrc/flash_decode_tile.cu`) on the CPU.

The card runs the tile arm for bf16 q at n > DECODE_ROWS query rows;
`flash_decode_tile_plain` is its arithmetic in plain PyTorch (64-key
tiles in order, S scaled in fp32, P formed in base 2 and multiplied into
V as the bf16 pair hi = bf16(P), lo = bf16(P - hi), int8 K/V as integers
with the scales on S's and P's columns, keys no row reads zeroed). Here the model meets the JAX
package's Pallas kernels, run in interpret mode as the JAX tests run
them, for every decode variant (plain, block-sparse, paged, block-sparse
paged; each with its int8 arm), and itself for the bit identities the
kernel keeps on the card. The kernel is held against the plain version on
the card by `chip_smoke.py` (phases 2, 3 and 10).

Tolerances: float32 inputs 2e-5 absolute (summation order, and 2^x
against e^x on the scaled scores); bfloat16 inputs 2^-7 * max(1, max
|ref|), `chip_smoke.py`'s `decode_tol` for the card's decode kernels (the
model carries P as a bf16 pair and rounds the output to bf16, the Pallas
kernel rounds the output only); and, for P's precision, P_PAIR_RMS. A row that sees no key is zeros in the port (its contract), where
the Pallas kernel gives the mean of a V tile: such rows are compared with
`flash_decode_attention_plain` only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models.attention import _kv_quantize as j_quantize
from dalle_pytorch_tpu.ops import pallas_decode as jpd
from dalle_pytorch_tpu_torch.ops import flash_decode as fd

torch.set_num_threads(2)

B, H, S_LEN, BLOCK_K, PAGE = 3, 2, 200, 32, 40  # 5 pages of 40 = 200 positions
VARIANTS = [
    "plain", "int8", "block_sparse", "block_sparse_int8",
    "paged", "paged_int8", "block_sparse_paged", "block_sparse_paged_int8",
]
ROWS = [5, 64, 65, 130]
DIMS = [40, 64, 200]


def _lengths(n):
    """One row below n (its first rows see no key), one on a 64-key tile
    edge, one at the full (ragged) cache."""
    return np.asarray([n - 3, 128 if n <= 128 else 192, S_LEN], np.int32)


def _case(variant, n, d, seed):
    """numpy inputs of `variant`: q, the contiguous cache (int8 + scales
    when asked), a bitmap (over BLOCK_K blocks, or pages when paged) and a
    shuffled page table with the pools it reads (page 0 never mapped)."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(*shape).astype(np.float32) for shape in ((B, H, n, d), (B, H, S_LEN, d), (B, H, S_LEN, d)))
    ks = vs = None
    if variant.endswith("int8"):
        (k, ks), (v, vs) = (tuple(np.array(x) for x in j_quantize(jnp.asarray(t))) for t in (k, v))
    paged = "paged" in variant
    nb = S_LEN // PAGE if paged else -(-S_LEN // BLOCK_K)
    bm = None
    if variant.startswith("block_sparse"):
        bm = (rng.rand(B, nb) < 0.5).astype(np.int32)
        bm[:, -1] = 1  # the last block stays live
    table = pools = None
    if paged:
        n_pages = S_LEN // PAGE
        table = (1 + rng.permutation(B * n_pages)).reshape(B, n_pages).astype(np.int32)
        pools = []
        for cache in (k, v, ks, vs):
            if cache is None:
                pools.append(None)
                continue
            pool = rng.randn(1 + B * n_pages, *cache.shape[1:2], PAGE, *cache.shape[3:]).astype(cache.dtype)
            for r in range(B):
                for j in range(n_pages):
                    pool[table[r, j]] = cache[r, :, j * PAGE : (j + 1) * PAGE]
            pools.append(pool)
    return q, k, v, ks, vs, bm, table, pools


def _visible_rows(variant, n, lengths, bm):
    """[B, n] bool: query rows that see at least one key."""
    pos = np.arange(S_LEN)
    bound = lengths[:, None] - n + np.arange(n)[None, :]
    vis = pos[None, None, :] <= bound[:, :, None]
    if bm is not None:
        block = PAGE if "paged" in variant else BLOCK_K
        vis = vis & (np.repeat(bm, block, axis=1)[:, :S_LEN] != 0)[:, None, :]
    return vis.any(-1)


def _pallas(variant, q, k, v, ks, vs, lengths, bm, table, pools, dtype):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jq, jl = jnp.asarray(q, jdt), jnp.asarray(lengths)
    kv = lambda x: jnp.asarray(x) if x.dtype == np.int8 else jnp.asarray(x, jdt)  # noqa: E731
    paged = "paged" in variant
    scales = {}
    if ks is not None:
        src = (pools[2], pools[3]) if paged else (ks, vs)
        scales = dict(k_scale=jnp.asarray(src[0]), v_scale=jnp.asarray(src[1]))
    if paged:
        args = (jq, kv(pools[0]), kv(pools[1]), jl, jnp.asarray(table))
        if bm is not None:
            return jpd.block_sparse_paged_flash_decode_attention(*args, jnp.asarray(bm), interpret=True, **scales)
        return jpd.paged_flash_decode_attention(*args, interpret=True, **scales)
    if bm is not None:
        return jpd.block_sparse_flash_decode_attention(
            jq, kv(k), kv(v), jl, jnp.asarray(bm), block_k=BLOCK_K, interpret=True, **scales)
    return jpd.flash_decode_attention(jq, kv(k), kv(v), jl, block_k=BLOCK_K, interpret=True, **scales)


def _t(x, dtype=None):
    if x is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(dtype) if dtype is not None and t.dtype == torch.float32 else t


def _model(variant, q, k, v, ks, vs, lengths, bm, table, pools, dtype):
    """flash_decode_tile_plain of `variant` (scales stay float32)."""
    paged = "paged" in variant
    kk, vv, sk, sv = pools if paged else (k, v, ks, vs)
    return fd.flash_decode_tile_plain(
        _t(q, dtype), _t(kk, dtype), _t(vv, dtype), _t(lengths), _t(sk), _t(sv),
        block_bitmap=_t(bm), block_k=None if paged else BLOCK_K, page_table=_t(table),
    )


def _plain(variant, q, k, v, ks, vs, lengths, bm, dtype):
    """The plain function on the contiguous cache (zeros for unseen rows)."""
    args = (_t(q, dtype), _t(k, dtype), _t(v, dtype), _t(lengths))
    sc = () if ks is None else (_t(ks), _t(vs))
    if bm is None:
        return fd.flash_decode_attention_plain(*args, *sc)
    block = PAGE if "paged" in variant else BLOCK_K
    return fd.block_sparse_flash_decode_attention_plain(*args, _t(bm), block, *sc)


def _hold(variant, n, d, dtype, seed):
    q, k, v, ks, vs, bm, table, pools = _case(variant, n, d, seed)
    lengths = _lengths(n)
    out = _model(variant, q, k, v, ks, vs, lengths, bm, table, pools, dtype)
    assert out.shape == (B, H, n, d) and out.dtype == dtype and torch.isfinite(out).all()
    ref = np.asarray(_pallas(variant, q, k, v, ks, vs, lengths, bm, table, pools, dtype).astype(jnp.float32))
    seen = _visible_rows(variant, n, lengths, bm)  # [B, n]
    assert (~seen).any() and seen.any()  # both kinds of rows are exercised
    got = out.float().numpy()
    if dtype == torch.bfloat16:
        tol = 2.0**-7 * max(1.0, float(np.abs(ref[seen[:, None, :].repeat(H, 1)]).max()))
    else:
        tol = 2e-5
    mask = np.broadcast_to(seen[:, None, :, None], got.shape)
    np.testing.assert_allclose(got[mask], ref[mask], atol=tol, rtol=0)
    plain = _plain(variant, q, k, v, ks, vs, lengths, bm, dtype).float().numpy()
    assert (got[~mask] == 0).all() and (plain[~mask] == 0).all()


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_tile_model_matches_the_pallas_kernels(variant, n):
    """The tile model against the Pallas kernel of each decode variant (rows
    1-5 of the kernel table, both arms), float32, over two and more
    64-key tiles and two 128-row query tiles, at head dims 40, 64 and 200 (each
    variant meets all three across its four n), a random bitmap and a
    shuffled page table whose 40-position pages straddle the key tiles."""
    d = DIMS[(VARIANTS.index(variant) + ROWS.index(n)) % len(DIMS)]
    _hold(variant, n, d, torch.float32, seed=7 * n + d)


@pytest.mark.parametrize("variant", ["plain", "int8", "block_sparse_int8", "block_sparse_paged"])
def test_tile_model_in_bfloat16(variant):
    """bf16 q (and cache) through the model, which carries P into P V as a
    bf16 pair as the kernel does, against the Pallas kernel under
    decode_tol."""
    _hold(variant, 65, 64, torch.bfloat16, seed=3)


# the rms over the rows that see a key of (tile model - Pallas kernel), both
# rounded to bf16 once at the end, on bf16 inputs
P_PAIR_RMS = 1e-4


@pytest.mark.parametrize("n,d,seed", [(130, 64, 3), (65, 40, 5), (130, 200, 7)])
def test_tile_model_carries_p_as_the_reference_does(n, d, seed):
    """P's precision in P V, the tile arm's departure behind ROADMAP Queue 3
    item 1: the reference multiplies fp32 P into the upcast V, the tile
    arm a bf16 pair hi = bf16(P), lo = bf16(P - hi) (two products into one
    fp32 accumulator, ~16 bits of P). Against the Pallas kernel in
    interpret mode, bf16 inputs, the rms of the difference over the rows
    that see a key must stay within P_PAIR_RMS = 1e-4; the model with one
    bf16 P (the arithmetic before the pair) must not. Readings at these
    cases (n, D): the pair 2.1e-5 (130, 64), 1.3e-5 (65, 40), 2.0e-5
    (130, 200); one bf16 P 4.0e-4, 4.6e-4, 4.1e-4; the share of outputs
    that differ from the Pallas kernel's bits 0.2% against 36-37%."""
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


@pytest.mark.parametrize("n", [5, 130])
@pytest.mark.parametrize("int8", [False, True])
def test_tile_model_bit_identities(int8, n):
    """The identities the kernel keeps on the card, held by its model: an
    all-ones bitmap gives the plain variant's bits (contiguous and paged),
    and the paged variants give the contiguous ones' bits on the gathered
    view, bitmap or not."""
    variant = "block_sparse_paged" + ("_int8" if int8 else "")
    q, k, v, ks, vs, bm, table, pools = _case(variant, n, 40, seed=n)
    lengths = _t(_lengths(n))
    tq = _t(q, torch.bfloat16)
    kp, vp = (_t(x, torch.bfloat16) for x in pools[:2])
    sc = () if ks is None else tuple(_t(x) for x in pools[2:])
    tt, tb = _t(table), _t(bm)
    ones = torch.ones_like(tb)
    plain_paged = fd.flash_decode_tile_plain(tq, kp, vp, lengths, *sc, page_table=tt)
    assert torch.equal(fd.flash_decode_tile_plain(tq, kp, vp, lengths, *sc, block_bitmap=ones, page_table=tt),
                       plain_paged)
    kg, vg = (fd.paged_gather(x, tt, S_LEN) for x in (kp, vp))
    scg = tuple(fd.paged_gather(x, tt, S_LEN) for x in sc)
    contiguous = fd.flash_decode_tile_plain(tq, kg, vg, lengths, *scg)
    assert torch.equal(plain_paged, contiguous)
    assert torch.equal(fd.flash_decode_tile_plain(tq, kg, vg, lengths, *scg, block_bitmap=ones, block_k=PAGE),
                       contiguous)
    sparse_paged = fd.flash_decode_tile_plain(tq, kp, vp, lengths, *sc, block_bitmap=tb, page_table=tt)
    assert torch.equal(sparse_paged,
                       fd.flash_decode_tile_plain(tq, kg, vg, lengths, *scg, block_bitmap=tb, block_k=PAGE))


@pytest.mark.parametrize("int8", [False, True])
def test_tile_model_never_reads_keys_no_row_sees(int8):
    """NaN in every cache position past each row's length and in each dead
    block (in the scales of an int8 cache) leaves the model's output
    finite and unchanged: those keys enter as zeros, as the kernel
    zero-fills them."""
    variant = "block_sparse" + ("_int8" if int8 else "")
    q, k, v, ks, vs, bm, _, _ = _case(variant, 65, 64, seed=11)
    lengths = _lengths(65)
    tq, tk, tv = (_t(x, torch.bfloat16) for x in (q, k, v))
    sc = () if ks is None else (_t(ks), _t(vs))
    tl, tb = _t(lengths), _t(bm)
    clean = fd.flash_decode_tile_plain(tq, tk, tv, tl, *sc, block_bitmap=tb, block_k=BLOCK_K)
    dead = ~(torch.arange(S_LEN)[None, :] < tl[:, None].long()) | ~fd.expand_bitmap(tb, BLOCK_K, S_LEN)
    if sc:
        sc = tuple(t.masked_fill(dead[:, None], float("nan")) for t in sc)
    else:
        tk, tv = (t.masked_fill(dead[:, None, :, None], float("nan")) for t in (tk, tv))
    poisoned = fd.flash_decode_tile_plain(tq, tk, tv, tl, *sc, block_bitmap=tb, block_k=BLOCK_K)
    assert torch.isfinite(poisoned).all() and torch.equal(poisoned, clean)


def test_tile_model_float32_is_the_plain_function():
    """In float32 (P as is) the tiles, base 2 and zero-filled keys
    leave the plain version's function: 2e-6."""
    q, k, v, _, _, _, _, _ = _case("plain", 130, 40, seed=5)
    args = (_t(q), _t(k), _t(v), _t(_lengths(130)))
    torch.testing.assert_close(fd.flash_decode_tile_plain(*args), fd.flash_decode_attention_plain(*args),
                               atol=2e-6, rtol=0)


def test_decode_arm_is_the_dispatch_rule():
    """The kernel a call launches on the card: the split-K step at n = 1,
    split-K up to DECODE_ROWS rows, above that the tile arm for bf16 q and
    the fp32 tile arm for fp32 q; above 256 channels the wide kernels, the
    split-K one up to DECODE_ROWS rows (at any D), above that the
    tensor-core tile kernel for bf16 q and the register-tiled
    `wide_decode_fma_kernel` for fp32 q, and the split-K one for the step
    at any width above 256 channels."""
    bf, f32 = torch.bfloat16, torch.float32
    assert fd.DECODE_ROWS == 4 and fd.DECODE_TILE == 64
    assert [fd.decode_arm(n, bf, 64) for n in (1, 2, 4, 5, 257, 1280)] == [
        "step", "split", "split", "tile", "tile", "tile"]
    assert [fd.decode_arm(n, f32, 64) for n in (1, 3, 5, 1280)] == ["step", "split", "tile_f32", "tile_f32"]
    assert [fd.decode_arm(5, bf, d) for d in (1, 40, 200, 256, 257, 1024)] == [
        "tile", "tile", "tile", "tile", "wide_tile", "wide_tile"]
    assert [fd.decode_arm(5, f32, d) for d in (8, 256, 257, 2048)] == [
        "tile_f32", "tile_f32", "wide_tile_f32", "wide_tile_f32"]
    assert [fd.decode_arm(n, dt, 320) for n in (1, 4) for dt in (bf, f32)] == ["wide_split"] * 4
    assert [fd.decode_arm(1, bf, d) for d in (257, 1024, 1025)] == ["wide_split", "wide_split", "wide_split"]


def test_cpu_wrappers_run_the_plain_version_and_count_no_tile_launch():
    """On CPU tensors every wrapper runs its plain version at n > 4 in bf16,
    counting no launch of any arm."""
    q, k, v, _, _, bm, table, pools = _case("block_sparse_paged", 65, 64, seed=2)
    tq = _t(q, torch.bfloat16)
    tk, tv = _t(k, torch.bfloat16), _t(v, torch.bfloat16)
    kp, vp = (_t(x, torch.bfloat16) for x in pools[:2])
    tl, tb, tt = _t(_lengths(65)), _t(bm), _t(table)
    fns = [fd.flash_decode_attention, fd.block_sparse_flash_decode_attention,
           fd.paged_flash_decode_attention, fd.block_sparse_paged_flash_decode_attention]
    before = [(f.launches, f.tile_launches, f.tile_int8_launches) for f in fns]
    assert torch.equal(fd.flash_decode_attention(tq, tk, tv, tl), fd.flash_decode_attention_plain(tq, tk, tv, tl))
    fd.block_sparse_flash_decode_attention(tq, tk, tv, tl, torch.ones((B, 7), dtype=torch.int32), BLOCK_K)
    fd.paged_flash_decode_attention(tq, kp, vp, tl, tt)
    fd.block_sparse_paged_flash_decode_attention(tq, kp, vp, tl, tt, tb)
    assert [(f.launches, f.tile_launches, f.tile_int8_launches) for f in fns] == before
