"""Discrete VAE: the encoder, the Gumbel-softmax codebook sampling, the
pixel decoder and the training losses.

Counterpart of the JAX package's `models/dvae.py:DiscreteVAE`:

* encoder: per-channel normalization (`norm`, (x - 0.5) / 0.5), then
  `num_layers` stride-2 4x4 convs with ReLU, `num_resnet_blocks`
  ResBlocks and a 1x1 head to `num_tokens` logits (`encode_logits`);
  `get_codebook_indices` is their argmax, the trainer's in-step encode
  and `precompute_tokens`' offline one;
* decoder (`decode`): codebook lookup -> [1x1 projection + ResBlocks when
  num_resnet_blocks > 0] -> `num_layers` stride-2 4x4 transposed convs
  with ReLU -> 1x1 head (`decode_embeds` from the embeddings);
* training forward (`forward`, the JAX `__call__`): the logits, a
  Gumbel-softmax sample over the codebook axis at temperature `temp`
  (hard with the straight-through gradient when `straight_through`,
  ReinMax when `reinmax` too; `ops/gumbel.py`), its product with the
  codebook and the decode; with `return_loss` the reconstruction loss
  against the normalized input (`smooth_l1_loss` or `mse_loss`, in
  float32) plus `kl_div_loss_weight` times the KL divergence of the
  codes' distribution from the uniform one (float32, summed over
  positions and codes, divided by the batch).

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

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dalle_pytorch_tpu_torch.ops.gumbel import gumbel_noise, gumbel_softmax

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


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The reference's smooth L1 (beta 1, mean over every element)."""
    diff = (pred - target).abs()
    return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5).mean()


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


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

    def weights_read_outside_modules(self):
        """The parameters the forward reads outside their own module's
        forward (`parallel/fsdp.py` gathers them around the whole forward):
        the codebook, multiplied by the Gumbel-softmax sample."""
        return ("codebook.weight",)

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
        return self.decode_embeds(emb.reshape(b, hw, hw, d))

    def decode_embeds(self, emb: torch.Tensor) -> torch.Tensor:
        """[B, h, w, codebook_dim] embeddings -> [B, H, W, C] image."""
        x = emb.permute(0, 3, 1, 2)
        if self.dec_proj is not None:
            x = self.dec_proj(x)
        for blk in self.dec_res:
            x = blk(x)
        for conv in self.dec_convs:
            x = F.relu(conv(x))
        return self.dec_head(x).permute(0, 2, 3, 1)

    def forward(
        self,
        img: torch.Tensor,
        return_loss: bool = False,
        return_recons: bool = False,
        return_logits: bool = False,
        temp: Optional[float] = None,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """img [B, H, W, C] in [0, 1]. Returns the logits (`return_logits`),
        else the reconstruction [B, H, W, C] from a Gumbel-softmax sample
        at `temp` (the model's `temperature` when None), or with
        `return_loss` the loss (and the reconstruction with
        `return_recons`). The Gumbel noise is `noise` ([B, h, w,
        num_tokens]) or drawn from `generator`."""
        logits = self.encode_logits(img)
        if return_logits:
            return logits
        temp = self.temperature if temp is None else temp
        if noise is None:
            noise = gumbel_noise(logits.shape, generator, logits.device, logits.dtype)
        one_hot = gumbel_softmax(
            logits, noise, tau=temp, hard=self.straight_through,
            reinmax=self.straight_through and self.reinmax,
        )
        sampled = one_hot @ self.codebook.weight.to(one_hot.dtype)
        out = self.decode_embeds(sampled)
        if not return_loss:
            return out
        loss_fn = smooth_l1_loss if self.smooth_l1_loss else mse_loss
        recon_loss = loss_fn(self.norm(img).float(), out.float())
        b = logits.shape[0]
        log_qy = F.log_softmax(logits.float(), dim=-1)
        log_uniform = -math.log(float(self.num_tokens))
        kl_div = (log_qy.exp() * (log_qy - log_uniform)).sum() / b
        loss = recon_loss + kl_div * self.kl_div_loss_weight
        if not return_recons:
            return loss
        return loss, out
