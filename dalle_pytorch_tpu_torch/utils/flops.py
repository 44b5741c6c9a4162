"""Analytic FLOPs model for the trainer's throughput and MFU.

Counterpart of the JAX package's `utils/flops.py`: matrix-product FLOPs
only (the tensor-core work), as MFU is usually quoted; elementwise,
softmax and embedding work is left out, as are recomputed layers and the
frozen in-step dVAE encode. `transformer_train_flops` and
`dalle_train_flops_per_sample` are the reference's formulas.

The peak is the card's: the published dense bf16 tensor-core rate of the
H100 SXM, PCIe and NVL (NVIDIA data sheets, the figures `chip_smoke.py`
bounds its kernels with), picked from the device name. Any other device
(the CPU, another card) has no peak here, and `mfu` gives None for it:
no TPU figure stands in.
"""

from __future__ import annotations

from typing import Optional

# dense bf16 peak FLOP/s, by the variant named in torch.cuda.get_device_name
H100_BF16_PEAKS = {"H100 PCIe": 756e12, "H100 NVL": 835e12, "H100 SXM": 989e12}


def peak_flops(device_name: str) -> Optional[float]:
    """The card's dense bf16 peak, or None for a device not in the table."""
    if "H100" not in device_name:
        return None
    for variant in ("PCIe", "NVL"):
        if variant in device_name:
            return H100_BF16_PEAKS[f"H100 {variant}"]
    return H100_BF16_PEAKS["H100 SXM"]  # "NVIDIA H100 80GB HBM3" is the SXM part


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
