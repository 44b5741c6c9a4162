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

from dalle_pytorch_tpu.ops.pallas_decode import flash_decode_attention as jax_flash_decode
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
    with pytest.raises(ValueError, match="head dim"):
        flash_decode_attention(q[..., :8], k[..., :8], v[..., :8], lengths)
    with pytest.raises(ValueError, match=r"\[B, H, S, D\]"):
        flash_decode_attention(q, k[:, :1], v[:, :1], lengths)


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
