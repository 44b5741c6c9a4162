"""Per-row sampling for the batched cached decode.

Counterpart of the JAX package's `ops/sampling.py:top_k_filter`,
`top_k_filter_per_row`, `per_row_step_keys` and `gumbel_sample_per_row`.

Noise contract: row i's Gumbel noise at a decode step is a pure function
of (its request seed, the image position) — never of batch composition,
row index or wall-clock step — so a request gets the same tokens alone or
padded into any batch. The port does not reproduce jax.random's bits; it
draws from a source of its own: torch's generator on the engine's device
(Philox on CUDA), reseeded with a hash of (seed, position) for every row
and step. Tests inject the same numpy-made noise into both packages
through `noise=`. The samplers that take one seed for a batch
(`generate_images`, `generate_images_cached`, `generate_texts` in
`models/dalle.py`) give row r the seed `row_seed(seed, r)`, so their
noise is a pure function of (seed, row, position), the same in the
cached and uncached samplers.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch


def keep_count(thres: float, vocab: int) -> int:
    """Logits a fractional top-k threshold keeps: max(int((1 - thres) V), 1),
    `thres` the fraction of the vocabulary dropped."""
    return max(int((1.0 - thres) * vocab), 1)


def top_k_filter(logits: torch.Tensor, thres: float = 0.5) -> torch.Tensor:
    """Every row keeps its `keep_count(thres, V)` largest logits (ties with
    the k-th too); the rest become -inf."""
    k = keep_count(thres, logits.shape[-1])
    kth = torch.topk(logits.float(), k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


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


def row_seed(seed: int, row: int) -> int:
    """The noise seed of batch row `row` under one batch seed `seed`."""
    return noise_seed(seed, row) & 0x7FFFFFFF


def gumbel_noise(
    seeds: Sequence[int], positions: Union[int, Sequence[int]], vocab: int, device
) -> torch.Tensor:
    """[len(seeds), vocab] float32 Gumbel noise, row i keyed by (seeds[i],
    positions[i]); one int `positions` puts every row at that position
    (the reference's `per_row_step_keys`)."""
    if isinstance(positions, int):
        positions = [positions] * len(seeds)
    generator = torch.Generator(device=device)
    rows = []
    for s, p in zip(seeds, positions):
        generator.manual_seed(noise_seed(s, p))
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
