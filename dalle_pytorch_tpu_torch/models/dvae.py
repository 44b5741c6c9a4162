"""Discrete VAE pixel decoder.

Counterpart of the JAX package's `models/dvae.py:DiscreteVAE.decode`:
codebook lookup -> [1x1 projection + ResBlocks when num_resnet_blocks > 0]
-> `num_layers` stride-2 4x4 transposed convs with ReLU -> 1x1 head.
The encoder and training losses are not ported yet.

Layout: the public `decode` takes token ids [B, n] and returns images
[B, H, W, C] like the reference (NHWC); inside, convolutions run NCHW.
Parity note: flax `ConvTranspose(strides=2, kernel 4, padding="SAME")`
equals `conv_transpose2d(stride=2, padding=1)` with the HWIO kernel
flipped in both spatial axes and laid out [in, out, kh, kw]; `weights.py`
does that conversion when it loads a reference tree.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


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
    ):
        super().__init__()
        if not math.log2(image_size).is_integer():
            raise ValueError("image size must be a power of 2")
        if num_layers < 1:
            raise ValueError("num_layers must be >= 1")
        self.image_size = image_size
        self.num_tokens = num_tokens
        self.num_layers = num_layers
        self.num_resnet_blocks = num_resnet_blocks
        self.codebook = nn.Embedding(num_tokens, codebook_dim)
        has_res = num_resnet_blocks > 0
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
