"""The port's flash-decode function vs the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX side
runs `ops/pallas_decode.py:flash_decode_attention` in Pallas interpret
mode, as its own tests do. The CUDA kernel is held against the plain
version on the card by `chip_smoke.py`.

Tolerances: float32 outputs hold to 2e-5 absolute (the two sum in
different orders); bfloat16 outputs to 1e-2 absolute, one bf16 rounding
step at |out| < 2 — both accumulate in float32 and round once at the end.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models.attention import _kv_quantize as j_quantize
from dalle_pytorch_tpu.ops import pallas_decode as jpd
from dalle_pytorch_tpu.ops.pallas_decode import flash_decode_attention as jax_flash_decode
from dalle_pytorch_tpu_torch.ops import flash_decode as fd
from dalle_pytorch_tpu_torch.ops.flash_decode import (
    flash_decode_attention,
    flash_decode_attention_plain,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _inputs(b, h, n, s, d, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(
        rng.randn(*shape).astype(np.float32)
        for shape in ((b, h, n, d), (b, h, s, d), (b, h, s, d))
    )


def _compare(q, k, v, lengths, block_k=128, dtype=torch.float32, atol=2e-5):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = jax_flash_decode(
        *(jnp.asarray(x, jdt) for x in (q, k, v)),
        jnp.asarray(lengths, jnp.int32),
        block_k=block_k,
        interpret=True,
    )
    out = flash_decode_attention_plain(
        *(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
        torch.tensor(lengths, dtype=torch.int32),
    )
    assert out.dtype == dtype
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=atol, rtol=0
    )


def test_single_token_per_row_lengths():
    q, k, v = _inputs(4, 2, 1, 37, 16)
    _compare(q, k, v, [1, 9, 20, 37], block_k=8)


def test_chunk_is_causal_within_the_chunk():
    q, k, v = _inputs(3, 2, 9, 40, 32, seed=1)
    _compare(q, k, v, [9, 17, 40], block_k=16)


@pytest.mark.parametrize("lengths", [[8, 16, 17, 41], [7, 24, 25, 33]])
def test_lengths_at_tile_edges_and_ragged_cache(lengths):
    """S = 41 is not a multiple of the 8-wide tile; lengths sit on, just
    below and just above tile boundaries, and at the full cache."""
    q, k, v = _inputs(4, 2, 3, 41, 16, seed=2)
    _compare(q, k, v, lengths, block_k=8)


def test_bfloat16_inputs():
    q, k, v = _inputs(2, 4, 5, 70, 64, seed=3)
    _compare(q, k, v, [30, 70], block_k=16, dtype=torch.bfloat16, atol=1e-2)


def test_cpu_wrapper_is_the_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 2, 4, 19, 32, seed=4))
    lengths = torch.tensor([4, 19], dtype=torch.int32)
    before = flash_decode_attention.launches
    out = flash_decode_attention(q, k, v, lengths)
    assert torch.equal(out, flash_decode_attention_plain(q, k, v, lengths))
    assert flash_decode_attention.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 1, 8, 32, seed=5))
    lengths = torch.tensor([8], dtype=torch.int32)
    with pytest.raises(TypeError):
        flash_decode_attention(q.double(), k.double(), v.double(), lengths)
    with pytest.raises(ValueError, match="int32"):
        flash_decode_attention(q, k, v, lengths.long())
    with pytest.raises(ValueError, match="contiguous"):
        flash_decode_attention(q.repeat(1, 1, 1, 2)[..., ::2], k, v, lengths)
    # a head dim outside the kernels' instances is the reference's function
    q8, k8, v8 = (t[..., :8].contiguous() for t in (q, k, v))
    ref = jax_flash_decode(
        *(jnp.asarray(t.numpy()) for t in (q8, k8, v8)), jnp.asarray(lengths.numpy()),
        block_k=4, interpret=True,
    )
    np.testing.assert_allclose(
        flash_decode_attention(q8, k8, v8, lengths).numpy(), np.asarray(ref), atol=2e-5, rtol=0
    )
    with pytest.raises(ValueError, match=r"\[B, H, S, D\]"):
        flash_decode_attention(q, k[:, :1], v[:, :1], lengths)


VARIANTS = ["plain", "int8", "block_sparse", "paged", "block_sparse_paged"]


@pytest.mark.parametrize("d", [8, 40, 48, 200])
@pytest.mark.parametrize("variant", VARIANTS)
def test_every_variant_takes_any_head_dim(variant, d):
    """Each of the five decode functions (plain and int8 arms, block-sparse,
    paged, block-sparse paged) at head dims that are not multiples of 16
    or lie above 128 (the card's kernels take any D <= 256), through the
    port's wrappers on the CPU and the Pallas kernels in interpret mode:
    2e-5 (float32 summation order)."""
    b, h, n, page, n_pages = 3, 2, 3, 8, 5
    s_len = page * n_pages
    rng = np.random.RandomState(d)
    q, k, v = _inputs(b, h, n, s_len, d, seed=d + 1)
    lengths = np.asarray([3, 21, 40], np.int32)
    scales = {}
    if variant == "int8":
        (k, ks), (v, vs) = (tuple(np.array(x) for x in j_quantize(jnp.asarray(t))) for t in (k, v))
        scales = dict(k_scale=ks, v_scale=vs)
    bm = (rng.rand(b, n_pages) < 0.6).astype(np.int32)
    bm[:, 0] = 1  # a row with no live block has no softmax support
    table = rng.permutation(b * n_pages).reshape(b, n_pages).astype(np.int32)
    # the pool: row r's page j holds cache positions [j*page, (j+1)*page)
    pool_k, pool_v = (np.zeros((b * n_pages, h, page, d), np.float32) for _ in range(2))
    for r in range(b):
        for j in range(n_pages):
            pool_k[table[r, j]] = k[r, :, j * page : (j + 1) * page]
            pool_v[table[r, j]] = v[r, :, j * page : (j + 1) * page]
    j_args = dict(interpret=True, **{key: jnp.asarray(x) for key, x in scales.items()})
    t_scales = [torch.from_numpy(x) for x in scales.values()]
    jq, jl = jnp.asarray(q), jnp.asarray(lengths)
    tq, tl = torch.from_numpy(q), torch.from_numpy(lengths)
    if variant in ("plain", "int8"):
        ref = jpd.flash_decode_attention(jq, jnp.asarray(k), jnp.asarray(v), jl, block_k=page, **j_args)
        out = fd.flash_decode_attention(tq, torch.from_numpy(k), torch.from_numpy(v), tl, *t_scales)
    elif variant == "block_sparse":
        ref = jpd.block_sparse_flash_decode_attention(
            jq, jnp.asarray(k), jnp.asarray(v), jl, jnp.asarray(bm), block_k=page, **j_args
        )
        out = fd.block_sparse_flash_decode_attention(
            tq, torch.from_numpy(k), torch.from_numpy(v), tl, torch.from_numpy(bm), page
        )
    elif variant == "paged":
        ref = jpd.paged_flash_decode_attention(
            jq, jnp.asarray(pool_k), jnp.asarray(pool_v), jl, jnp.asarray(table), **j_args
        )
        out = fd.paged_flash_decode_attention(
            tq, torch.from_numpy(pool_k), torch.from_numpy(pool_v), tl, torch.from_numpy(table)
        )
    else:
        ref = jpd.block_sparse_paged_flash_decode_attention(
            jq, jnp.asarray(pool_k), jnp.asarray(pool_v), jl, jnp.asarray(table),
            jnp.asarray(bm), **j_args,
        )
        out = fd.block_sparse_paged_flash_decode_attention(
            tq, torch.from_numpy(pool_k), torch.from_numpy(pool_v), tl, torch.from_numpy(table),
            torch.from_numpy(bm),
        )
    assert out.shape == (b, h, n, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


def test_kernel_head_dims_are_the_multiples_of_16_up_to_128():
    """The card's head-dim rule (the test keeps its name): every D from 1
    to 256 is taken, multiples of 16 or not (head dim is a runtime
    argument of the kernels); above 256 raises naming the open remainder
    (the CPU path takes any D)."""
    for d in (1, 8, 16, 36, 40, 64, 72, 100, 128, 144, 200, 256):
        fd.check_kernel_head_dim(d)
    assert fd.MAX_KERNEL_HEAD_DIM == 256
    for d in (0, 257, 264, 512):
        with pytest.raises(ValueError, match="Queue 3"):
            fd.check_kernel_head_dim(d)


def _pallas_variant(variant, q, k, v, lengths, bm, block_k, scales):
    """The Pallas kernel (interpret mode) of `variant` ("plain" or
    "block_sparse", each taking the int8 scales) on the contiguous cache."""
    j = dict(interpret=True, **{key: jnp.asarray(x) for key, x in scales.items()})
    jq, jl = jnp.asarray(q), jnp.asarray(lengths)
    if variant == "plain":
        return jpd.flash_decode_attention(jq, jnp.asarray(k), jnp.asarray(v), jl, block_k=block_k, **j)
    if variant == "block_sparse":
        return jpd.block_sparse_flash_decode_attention(
            jq, jnp.asarray(k), jnp.asarray(v), jl, jnp.asarray(bm), block_k=block_k, **j
        )
    raise ValueError(variant)


@pytest.mark.parametrize("d", [16, 40])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("variant", ["plain", "int8", "block_sparse", "block_sparse_int8"])
def test_split_k_model_matches_the_pallas_kernels(variant, n, d):
    """`flash_decode_split_plain`, the card kernels' split-K arithmetic
    (per-span m, l, acc merged in span order), against the Pallas kernels
    in interpret mode on the contiguous cache: spans of 8 positions over a
    43-position cache, lengths that are not multiples of the span (one row
    inside its first span), int8 with scales, and block-sparse bitmaps
    that leave whole spans with no live key. 2e-5 (float32 summation
    order); its n > 4 case is one span, the plain version's function."""
    b, h, s_len, span, block_k = 3, 2, 43, 8, 4
    q, k, v = _inputs(b, h, n, s_len, d, seed=d + n)
    lengths = np.asarray([n + 2, 29, 43], np.int32)
    scales = {}
    if variant.endswith("int8"):
        (k, ks), (v, vs) = (tuple(np.array(x) for x in j_quantize(jnp.asarray(t))) for t in (k, v))
        scales = dict(k_scale=ks, v_scale=vs)
    nb = -(-s_len // block_k)
    bm = None
    if variant.startswith("block_sparse"):
        bm = np.zeros((b, nb), np.int32)
        bm[:, 0] = 1
        bm[1, [3, 7]] = 1  # blocks 4-5 (span 1, positions 8-15) and 8-9 dead
        bm[2, [2, 5, 10]] = 1
    ref = _pallas_variant(
        "block_sparse" if bm is not None else "plain", q, k, v, lengths, bm, block_k, scales
    )
    t_scales = [torch.from_numpy(x) for x in scales.values()]
    out = fd.flash_decode_split_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(lengths),
        *t_scales, block_bitmap=None if bm is None else torch.from_numpy(bm), block_k=block_k,
        span=span,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    assert torch.isfinite(out).all()


def test_split_k_model_writes_zeros_for_a_row_with_no_key_and_one_span_is_plain():
    """A row of length 0 sees no key in any span: zeros, as the kernels
    write it. For n > DECODE_ROWS (the prefill chunk) the model is one
    span and gives the plain version's function."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 2, 1, 30, 24, seed=9))
    lengths = torch.tensor([0, 30], dtype=torch.int32)
    out = fd.flash_decode_split_plain(q, k, v, lengths, span=8)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    torch.testing.assert_close(out[1], fd.flash_decode_attention_plain(q, k, v, lengths)[1],
                               atol=2e-6, rtol=0)
    q5 = torch.from_numpy(_inputs(2, 2, 6, 30, 24, seed=10)[0])
    lengths = torch.tensor([6, 30], dtype=torch.int32)
    torch.testing.assert_close(fd.flash_decode_split_plain(q5, k, v, lengths, span=8),
                               fd.flash_decode_attention_plain(q5, k, v, lengths), atol=2e-6, rtol=0)


def test_import_needs_neither_nvcc_nor_triton():
    """Importing the module (and calling it on the CPU) builds nothing: a
    process with no nvcc on PATH and `triton` refused imports it."""
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
        from dalle_pytorch_tpu_torch.ops import flash_decode as fd
        q = torch.zeros(1, 1, 1, 32)
        fd.flash_decode_attention(q, q, q, torch.ones(1, dtype=torch.int32))
        assert kernels.build_log == {} and fd.flash_decode_attention.launches == 0
        print("ok")
        """
    )
    env = {**os.environ, "PATH": "/usr/bin:/bin", "CUDA_HOME": "/nonexistent"}
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
