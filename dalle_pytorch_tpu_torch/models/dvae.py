"""Discrete VAE: the frozen encoder and the pixel decoder.

Counterpart of the JAX package's `models/dvae.py:DiscreteVAE`:

* encoder: per-channel normalization (`norm`, (x - 0.5) / 0.5), then
  `num_layers` stride-2 4x4 convs with ReLU, `num_resnet_blocks`
  ResBlocks and a 1x1 head to `num_tokens` logits (`encode_logits`);
  `get_codebook_indices` is their argmax, the trainer's in-step encode
  and `precompute_tokens`' offline one;
* decoder (`decode`): codebook lookup -> [1x1 projection + ResBlocks when
  num_resnet_blocks > 0] -> `num_layers` stride-2 4x4 transposed convs
  with ReLU -> 1x1 head.

The gumbel-softmax forward and the training losses are not ported yet;
the constructor keeps their settings (`smooth_l1_loss`, `temperature`,
`straight_through`, `reinmax`, `kl_div_loss_weight`) so that a
checkpoint's hyperparameters round-trip.

Precision: the encode runs in full float32 wherever it runs
(`exact_float32`: no TF32 in cuDNN's convolutions or cuBLAS's products,
whatever the process set), since a token is an argmax that TF32's 10-bit
mantissa can move; the trainer's sample decode takes the same context.

Layout: the public methods take and return NHWC like the reference
(images [B, H, W, C], logits [B, h, w, num_tokens]); inside, convolutions
run NCHW. Parity notes: flax `Conv(kernel 4, strides 2, padding=1)` is
`conv2d(stride=2, padding=1)` with the HWIO kernel laid out OIHW; flax
`ConvTranspose(strides=2, kernel 4, padding="SAME")` equals
`conv_transpose2d(stride=2, padding=1)` with the HWIO kernel flipped in
both spatial axes and laid out [in, out, kh, kw]; `weights.py` does both
conversions when it loads a reference tree.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

NORMALIZATION = ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5))  # per-channel (means, stds)


@contextlib.contextmanager
def exact_float32():
    """Float32 convolutions and matmuls without TF32 (torch's default lets
    cuDNN use it) inside; the process's settings restored after."""
    cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = cudnn, matmul


class ResBlock(nn.Module):
    def __init__(self, chan: int):
        super().__init__()
        self.conv_0 = nn.Conv2d(chan, chan, 3, padding=1)
        self.conv_1 = nn.Conv2d(chan, chan, 3, padding=1)
        self.conv_2 = nn.Conv2d(chan, chan, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.conv_0(x))
        h = F.relu(self.conv_1(h))
        return self.conv_2(h) + x


class DiscreteVAE(nn.Module):
    def __init__(
        self,
        image_size: int = 256,
        num_tokens: int = 512,
        codebook_dim: int = 512,
        num_layers: int = 3,
        num_resnet_blocks: int = 0,
        hidden_dim: int = 64,
        channels: int = 3,
        smooth_l1_loss: bool = False,
        temperature: float = 0.9,
        straight_through: bool = False,
        reinmax: bool = False,
        kl_div_loss_weight: float = 0.0,
    ):
        super().__init__()
        if not math.log2(image_size).is_integer():
            raise ValueError("image size must be a power of 2")
        if num_layers < 1:
            raise ValueError("num_layers must be >= 1")
        self.image_size = image_size
        self.num_tokens = num_tokens
        self.codebook_dim = codebook_dim
        self.num_layers = num_layers
        self.num_resnet_blocks = num_resnet_blocks
        self.hidden_dim = hidden_dim
        self.channels = channels
        self.smooth_l1_loss = smooth_l1_loss
        self.temperature = temperature
        self.straight_through = straight_through
        self.reinmax = reinmax
        self.kl_div_loss_weight = kl_div_loss_weight
        self.codebook = nn.Embedding(num_tokens, codebook_dim)
        has_res = num_resnet_blocks > 0

        self.enc_convs = nn.ModuleList(
            nn.Conv2d(channels if i == 0 else hidden_dim, hidden_dim, 4, stride=2, padding=1)
            for i in range(num_layers)
        )
        self.enc_res = nn.ModuleList(ResBlock(hidden_dim) for _ in range(num_resnet_blocks))
        self.enc_head = nn.Conv2d(hidden_dim, num_tokens, 1)

        self.dec_proj = nn.Conv2d(codebook_dim, hidden_dim, 1) if has_res else None
        self.dec_res = nn.ModuleList(ResBlock(hidden_dim) for _ in range(num_resnet_blocks))
        chans = [hidden_dim if has_res else codebook_dim] + [hidden_dim] * num_layers
        self.dec_convs = nn.ModuleList(
            nn.ConvTranspose2d(chans[i], chans[i + 1], 4, stride=2, padding=1)
            for i in range(num_layers)
        )
        self.dec_head = nn.Conv2d(hidden_dim, channels, 1)

    @property
    def fmap_size(self) -> int:
        return self.image_size // (2**self.num_layers)

    def norm(self, images: torch.Tensor) -> torch.Tensor:
        """[..., C] images -> (images - means) / stds per channel."""
        means = images.new_tensor(NORMALIZATION[0][: self.channels])
        stds = images.new_tensor(NORMALIZATION[1][: self.channels])
        return (images - means) / stds

    def encode_logits(self, img: torch.Tensor) -> torch.Tensor:
        """img [B, H, W, C] -> token logits [B, h, w, num_tokens], in
        full float32 (`exact_float32`)."""
        if img.shape[1] != self.image_size or img.shape[2] != self.image_size:
            raise ValueError(
                f"input must have the correct image size {self.image_size}, "
                f"got {img.shape[1]}x{img.shape[2]}"
            )
        with exact_float32():
            x = self.norm(img).permute(0, 3, 1, 2)
            for conv in self.enc_convs:
                x = F.relu(conv(x))
            for blk in self.enc_res:
                x = blk(x)
            return self.enc_head(x).permute(0, 2, 3, 1)

    def get_codebook_indices(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] -> [B, h*w] int64 codebook indices (the frozen encode)."""
        logits = self.encode_logits(images)
        return logits.argmax(dim=-1).reshape(logits.shape[0], -1)

    def decode(self, img_seq: torch.Tensor) -> torch.Tensor:
        """[B, n] codebook indices -> [B, H, W, C] image (normalized space)."""
        emb = self.codebook(img_seq.long())
        b, n, d = emb.shape
        hw = math.isqrt(n)
        x = emb.reshape(b, hw, hw, d).permute(0, 3, 1, 2)
        if self.dec_proj is not None:
            x = self.dec_proj(x)
        for blk in self.dec_res:
            x = blk(x)
        for conv in self.dec_convs:
            x = F.relu(conv(x))
        return self.dec_head(x).permute(0, 2, 3, 1)
