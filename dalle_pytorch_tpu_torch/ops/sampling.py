"""Per-row sampling for the batched cached decode.

Counterpart of the JAX package's `ops/sampling.py:top_k_filter_per_row`,
`per_row_step_keys` and `gumbel_sample_per_row`.

Noise contract: row i's Gumbel noise at a decode step is a pure function
of (its request seed, the image position) — never of batch composition,
row index or wall-clock step — so a request gets the same tokens alone or
padded into any batch. The port does not reproduce jax.random's bits; it
draws from a source of its own: torch's generator on the engine's device
(Philox on CUDA), reseeded with a hash of (seed, position) for every row
and step. Tests inject the same numpy-made noise into both packages
through `noise=`.
"""

from __future__ import annotations

from typing import Sequence

import torch


def top_k_filter_per_row(
    logits: torch.Tensor, keep_k: torch.Tensor, k_max: int
) -> torch.Tensor:
    """Row i keeps its keep_k[i] largest logits (ties with the k-th are
    kept too: the test is `logits < kth`); the rest become -inf.

    `k_max`, a host int >= max(keep_k), bounds the partial sort (keep_k
    lives on the device; reading its max there would sync every step).
    """
    k_max = max(1, min(int(k_max), logits.shape[-1]))
    top = torch.topk(logits.float(), k_max, dim=-1).values  # descending
    idx = (keep_k.to(torch.long) - 1).clamp(0, k_max - 1)
    kth = top.gather(-1, idx[:, None])
    return logits.masked_fill(logits < kth, float("-inf"))


def noise_seed(seed: int, position: int) -> int:
    """64-bit generator seed for (request seed, image position): the
    splitmix64 finalizer of seed << 32 | position, so that every bit of
    the result depends on both (the CPU generator keeps only 32 bits)."""
    x = (((int(seed) & 0x7FFFFFFF) << 32) | (int(position) & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15
    x &= 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def gumbel_noise(seeds: Sequence[int], position: int, vocab: int, device) -> torch.Tensor:
    """[len(seeds), vocab] float32 Gumbel noise, row i keyed by
    (seeds[i], position)."""
    generator = torch.Generator(device=device)
    rows = []
    for s in seeds:
        generator.manual_seed(noise_seed(s, position))
        rows.append(
            torch.rand(vocab, generator=generator, device=device, dtype=torch.float32)
        )
    u = torch.stack(rows).clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def gumbel_sample_per_row(
    logits: torch.Tensor,
    temperature: torch.Tensor,
    noise: torch.Tensor,
) -> torch.Tensor:
    """Gumbel-max: argmax(logits / max(t, 1e-4) + noise) per row, first
    index on ties. temperature: [B]; noise: [B, V] float32."""
    t = temperature.float().clamp(min=1e-4)[:, None]
    return torch.argmax(logits.float() / t + noise, dim=-1)
