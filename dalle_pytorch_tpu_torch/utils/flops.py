"""Analytic FLOPs model for the trainer's throughput and MFU.

Counterpart of the JAX package's `utils/flops.py`: matrix-product FLOPs
only (the tensor-core work), as MFU is usually quoted; elementwise,
softmax and embedding work is left out, as are recomputed layers and the
frozen in-step dVAE encode. `transformer_train_flops` and
`dalle_train_flops_per_sample` are the reference's formulas;
`decode_work` and `forward_cost` count a cached serving forward the same
way (the serving cost table's rows).

The peak is the card's: the published dense bf16 tensor-core rate of the
H100 SXM, PCIe and NVL (NVIDIA data sheets, the figures `chip_smoke.py`
bounds its kernels with), picked from the device name, and beside it the
same part's memory rate (`hbm_bytes_per_s`, the serving cost table's). Any other device
(the CPU, another card) has no peak here, and `mfu` gives None for it:
no TPU figure stands in.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

# dense bf16 peak FLOP/s, by the variant named in torch.cuda.get_device_name
H100_BF16_PEAKS = {"H100 PCIe": 756e12, "H100 NVL": 835e12, "H100 SXM": 989e12}
# HBM bytes/s of the same parts (NVIDIA data sheets)
H100_HBM_BPS = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H100 SXM": 3.35e12}


def _h100_variant(device_name: str) -> Optional[str]:
    if "H100" not in (device_name or ""):
        return None
    for variant in ("PCIe", "NVL"):
        if variant in device_name:
            return f"H100 {variant}"
    return "H100 SXM"  # "NVIDIA H100 80GB HBM3" is the SXM part


def peak_flops(device_name: str) -> Optional[float]:
    """The card's dense bf16 peak, or None for a device not in the table."""
    variant = _h100_variant(device_name)
    return None if variant is None else H100_BF16_PEAKS[variant]


def hbm_bytes_per_s(device_name: str) -> Optional[float]:
    """The card's memory rate, or None for a device not in the table."""
    variant = _h100_variant(device_name)
    return None if variant is None else H100_HBM_BPS[variant]


def transformer_train_flops(
    dim: int, depth: int, heads: int, dim_head: int, seq: int, ff_mult: int = 4,
    vocab: int = 0,
) -> float:
    """Matmul FLOPs per sample of one forward and backward pass; `vocab`
    adds the logits head."""
    inner = heads * dim_head
    per_layer = (
        2 * seq * dim * 3 * inner            # qkv proj
        + 2 * seq * seq * inner * 2          # qk^T and attn@v
        + 2 * seq * inner * dim              # out proj
        + 2 * seq * dim * dim * ff_mult * 2  # ff up (GEGLU: 2x width)
        + 2 * seq * dim * ff_mult * dim      # ff down
    )
    fwd = depth * per_layer + 2 * seq * dim * vocab
    return 3 * fwd  # fwd + 2x bwd


class DecodeWork:
    """The per-forward constants of a cached-decode model: `token_flops`
    (2 x the transformer's matrix weights, one token through every layer),
    `pair_flops` (4 * dim_head a head, summed over the heads and layers:
    one visible (query, key) pair), `logits_flops` (2 * dim * vocabulary,
    one logits row), `weight_bytes` (the matrix and logits weights, read
    once a forward) and `kv_bytes` (K and V of one position in every
    layer, with int8 scales)."""

    __slots__ = ("token_flops", "pair_flops", "logits_flops", "weight_bytes", "kv_bytes")

    def __init__(self, token_flops: float, pair_flops: float, logits_flops: float,
                 weight_bytes: float, kv_bytes: float):
        self.token_flops = float(token_flops)
        self.pair_flops = float(pair_flops)
        self.logits_flops = float(logits_flops)
        self.weight_bytes = float(weight_bytes)
        self.kv_bytes = float(kv_bytes)


def decode_work(
    dim: int, depth: int, heads: int, dim_head: int, vocab: int, ff_mult: int = 4,
    dtype_bytes: int = 2, kv_int8: bool = False, attn_layers: Optional[int] = None,
    ff_layers: Optional[int] = None,
) -> DecodeWork:
    """The `DecodeWork` of a DALLE from its configuration, with the
    matrix products of `transformer_train_flops` (qkv, out, the GEGLU's
    two) and `vocab` logits columns. Weights take `dtype_bytes` each, and
    the layers that shared ids leave distinct (`attn_layers` / `ff_layers`,
    default `depth`) are read once. K/V take `dtype_bytes` a channel, or
    one byte and an fp32 scale a head with `kv_int8`. It is the model's
    work: a tensor-parallel mesh splits it over its shards."""
    inner, hidden = heads * dim_head, ff_mult * dim
    attn = dim * 3 * inner + inner * dim
    ff = dim * 2 * hidden + hidden * dim
    kv = 2 * inner + 2 * heads * 4 if kv_int8 else 2 * inner * dtype_bytes
    return DecodeWork(
        token_flops=2 * depth * (attn + ff),
        pair_flops=4 * depth * inner,
        logits_flops=2 * dim * vocab,
        weight_bytes=dtype_bytes * ((attn_layers or depth) * attn + (ff_layers or depth) * ff + dim * vocab),
        kv_bytes=depth * kv,
    )


def forward_cost(work: DecodeWork, queries: Sequence[Tuple[int, int]], logits_rows: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one cached forward: `queries` holds each row's
    (n new positions, cache index), so the row's query i sees index + i + 1
    keys; `logits_rows` rows go through the logits head. Weights are read
    once, each row's visible K/V (index + n positions) read once and its n
    new positions written once."""
    tokens = sum(int(n) for n, _ in queries)
    pairs = sum(int(n) * int(index) + int(n) * (int(n) + 1) // 2 for n, index in queries)
    kv_positions = sum(int(index) + 2 * int(n) for n, index in queries)
    flops = tokens * work.token_flops + pairs * work.pair_flops + int(logits_rows) * work.logits_flops
    return flops, work.weight_bytes + kv_positions * work.kv_bytes


# objective mode -> full forward and backward passes a sample: the inverse
# objective runs the model a second time
OBJECTIVE_PASSES = {
    "forward_only": 1,
    "reverse_only": 1,
    "forward_forward": 2,
    "forward_reverse_partial": 2,
}


def dalle_train_flops_per_sample(model, mode: str = "forward_only") -> float:
    """FLOPs a sample of a DALLE training step under objective `mode`
    (gradient accumulation does not change it)."""
    return OBJECTIVE_PASSES[mode] * transformer_train_flops(
        model.dim, model.depth, model.heads, model.dim_head,
        model.total_seq_len, vocab=model.total_tokens,
    )


def mfu(samples_per_sec: float, flops_per_sample: float, device_name: str,
        n_devices: int = 1) -> Optional[float]:
    """Model FLOPs utilization against the card's peak; None where the
    device has no peak in the table."""
    peak = peak_flops(device_name)
    if peak is None:
        return None
    return samples_per_sec * flops_per_sample / (peak * n_devices)
