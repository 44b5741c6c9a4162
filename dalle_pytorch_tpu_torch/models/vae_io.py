"""Pretrained-VAE wrappers: OpenAI's discrete VAE and the taming VQGAN.

Counterpart of the JAX package's `models/vae_io.py` (`OpenAIDiscreteVAE`
with `_OpenAIGraph`, `VQGanVAE` with `_VQGraph`). Both read torch
checkpoints that must already be on disk (nothing is downloaded) and
evaluate their networks as functions of the checkpoint's tensors, which
they keep as buffers: `.to(device)` / `.to(dtype)` move them, and the
kernels stay OIHW as the pickles hold them (the JAX package's HWIO
conversion is not needed). The interface is the JAX wrappers': NHWC
images in [0, 1], `get_codebook_indices(images)` -> [B, h*w] indices,
`decode(indices)` -> NHWC images in [0, 1], `map_pixels` /
`unmap_pixels`, and the geometry `image_size`, `num_layers`,
`num_tokens`, `channels` (plus `fmap_size`), taken from the checkpoint.
`encode_scores` gives the scores whose argmax is the index (the OpenAI
encoder's logits; the VQGAN's negated codebook distances, or its Gumbel
projection's logits), for margin checks. The encode runs in full
float32 (`exact_float32`), as the dVAE's does: an index is an argmax.

* OpenAI (the dall_e package's Encoder / Decoder): an `input` conv,
  `group_1..group_N` of residual blocks (id path: a 1x1 conv where the
  width changes; residual path: four ReLU + convs scaled by 1 / (N *
  blocks)^2), 2x2 max-pooling (encoder) or nearest 2x upsampling
  (decoder) between groups, and a ReLU + 1x1 `output` conv. The
  structure comes from the state dict's keys; dall_e's `.w` / `.b` names
  and torch's `.weight` / `.bias` are both read. The decoder's input 1x1
  conv over a one-hot is the gather of its kernel's columns. The
  reference's geometry is 256 px, f/8, 8192 tokens.
* VQGAN (taming-transformers): GroupNorm(32) + swish ResnetBlocks with
  spatial attention at `attn_resolutions`, stride-2 downsampling after a
  (0, 1, 0, 1) pad, nearest 2x upsampling, and a nearest-codebook (or
  Gumbel argmax) quantizer. Its config is read as JSON when it parses as
  JSON (a JSON document is also YAML), else with PyYAML, which is then
  needed: without it the load raises, naming the package.

`CACHE_PATH` is where the OpenAI pickles are looked for (`encoder.pkl`,
`decoder.pkl`) when no directory is given.
"""

from __future__ import annotations

import json
import math
import os
import re
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dalle_pytorch_tpu_torch.models.dvae import DiscreteVAE, exact_float32

CACHE_PATH = Path(os.path.expanduser("~/.cache/dalle"))

OPENAI_VAE_ENCODER_NAME = "encoder.pkl"
OPENAI_VAE_DECODER_NAME = "decoder.pkl"


def _require(path: Path, what: str) -> Path:
    if not Path(path).exists():
        raise FileNotFoundError(
            f"{what} not found at {path}. Nothing is downloaded: place the "
            "checkpoint there (the reference fetches it from cdn.openai.com / heibox)."
        )
    return Path(path)


def _state_dict(obj) -> dict:
    """A loaded pickle (a module or a bare state dict) as {key: tensor}."""
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return {k: torch.as_tensor(v).detach().cpu() for k, v in obj.items()}


def _swish(x):
    return x * torch.sigmoid(x)


def _upsample2(h):
    return h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class _TensorGraph(nn.Module):
    """A network evaluated from named checkpoint tensors, held as buffers
    (a key's dots become "__" in the buffer's name)."""

    def _keep(self, state: dict) -> None:
        self._names = set()
        for key, value in state.items():
            self.register_buffer(key.replace(".", "__"), value.float().contiguous())
            self._names.add(key)

    def p(self, key: str) -> torch.Tensor:
        return getattr(self, key.replace(".", "__"))

    def has(self, key: str) -> bool:
        return key in self._names

    def conv(self, key: str, x, stride: int = 1, pad=None, suffix=("weight", "bias")):
        """Conv of x (NCHW) by `key`'s kernel: `pad` (left, right, top,
        bottom), else "same" padding ((k - 1) // 2 before, k // 2 after)."""
        w = self.p(f"{key}.{suffix[0]}").to(x.dtype)
        b = f"{key}.{suffix[1]}"
        bias = self.p(b).reshape(-1).to(x.dtype) if self.has(b) else None
        if pad is None:
            kh, kw = w.shape[2], w.shape[3]
            pad = ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2)
        return F.conv2d(F.pad(x, pad), w, bias, stride=stride)


class _OpenAIGraph(_TensorGraph):
    """The dall_e dVAE's encoder and decoder over their state dicts."""

    def __init__(self, enc_state: dict, dec_state: dict):
        super().__init__()
        state = {}
        for prefix, part in (("enc", enc_state), ("dec", dec_state)):
            for k, v in part.items():
                k = re.sub(r"\.weight$", ".w", re.sub(r"\.bias$", ".b", k))
                state[f"{prefix}.{k}"] = v
        self._keep(state)
        self.enc_groups, self.enc_blocks = self._structure(enc_state)
        self.dec_groups, self.dec_blocks = self._structure(dec_state)

    @staticmethod
    def _structure(state: dict):
        groups, blocks = 0, 0
        for k in state:
            m = re.search(r"group_(\d+)\.block_(\d+)\.", k)
            if m:
                groups = max(groups, int(m.group(1)))
                blocks = max(blocks, int(m.group(2)))
        if not (groups and blocks):
            raise ValueError("unrecognized dVAE state dict layout")
        return groups, blocks

    def _conv(self, key, x):
        return self.conv(key, x, suffix=("w", "b"))

    def _block(self, key, x, post_gain):
        h = x
        for i in (1, 2, 3, 4):
            h = self._conv(f"{key}.res_path.conv_{i}", F.relu(h))
        if self.has(f"{key}.id_path.w"):
            x = self._conv(f"{key}.id_path", x)
        return x + post_gain * h

    def encode_logits(self, x):
        """Pixel-mapped images NCHW -> token logits NCHW."""
        post_gain = 1.0 / (self.enc_groups * self.enc_blocks) ** 2
        h = self._conv("enc.blocks.input", x)
        for g in range(1, self.enc_groups + 1):
            for blk in range(1, self.enc_blocks + 1):
                h = self._block(f"enc.blocks.group_{g}.block_{blk}", h, post_gain)
            if g != self.enc_groups:
                h = F.max_pool2d(h, 2)
        return self._conv("enc.blocks.output.conv", F.relu(h))

    def decode_pixels(self, indices):
        """Flat indices [B, n] -> the decoder's raw output NCHW."""
        w = self.p("dec.blocks.input.w")  # [n_init, vocab, 1, 1]
        b, n = indices.shape
        hw = math.isqrt(n)
        h = w[:, :, 0, 0].t()[indices.long()] + self.p("dec.blocks.input.b").reshape(-1)
        h = h.reshape(b, hw, hw, -1).permute(0, 3, 1, 2)
        post_gain = 1.0 / (self.dec_groups * self.dec_blocks) ** 2
        for g in range(1, self.dec_groups + 1):
            for blk in range(1, self.dec_blocks + 1):
                h = self._block(f"dec.blocks.group_{g}.block_{blk}", h, post_gain)
            if g != self.dec_groups:
                h = _upsample2(h)
        return self._conv("dec.blocks.output.conv", F.relu(h))


class OpenAIDiscreteVAE(nn.Module):
    """OpenAI's pretrained dVAE from `encoder.pkl` / `decoder.pkl` in
    `cache_dir` (`CACHE_PATH` when None)."""

    image_size = 256
    channels = 3

    def __init__(self, cache_dir: Optional[Path] = None):
        super().__init__()
        cache = Path(cache_dir) if cache_dir else CACHE_PATH
        enc_path = _require(cache / OPENAI_VAE_ENCODER_NAME, "OpenAI dVAE encoder")
        dec_path = _require(cache / OPENAI_VAE_DECODER_NAME, "OpenAI dVAE decoder")
        self.graph = _OpenAIGraph(
            _state_dict(torch.load(enc_path, map_location="cpu")),
            _state_dict(torch.load(dec_path, map_location="cpu")),
        )
        # geometry from the pickles (the class's image size is the release's)
        self.num_tokens = int(self.graph.p("enc.blocks.output.conv.w").shape[0])
        self.num_layers = self.graph.enc_groups - 1  # one max-pool between groups

    @property
    def fmap_size(self) -> int:
        return self.image_size // (2**self.num_layers)

    @staticmethod
    def map_pixels(x: torch.Tensor, eps: float = 0.1) -> torch.Tensor:
        return (1 - 2 * eps) * x + eps

    @staticmethod
    def unmap_pixels(x: torch.Tensor, eps: float = 0.1) -> torch.Tensor:
        return torch.clamp((x - eps) / (1 - 2 * eps), 0, 1)

    def encode_scores(self, images: torch.Tensor) -> torch.Tensor:
        """NHWC images in [0, 1] -> the encoder's logits [B, h*w, num_tokens]."""
        with exact_float32():
            x = self.map_pixels(images.to(self.graph.p("enc.blocks.input.w").dtype))
            logits = self.graph.encode_logits(x.permute(0, 3, 1, 2))
        return logits.permute(0, 2, 3, 1).reshape(logits.shape[0], -1, logits.shape[1])

    def get_codebook_indices(self, images: torch.Tensor) -> torch.Tensor:
        """NHWC images in [0, 1] -> [B, h*w] token indices."""
        return self.encode_scores(images).argmax(dim=-1)

    def decode(self, img_seq: torch.Tensor) -> torch.Tensor:
        """[B, n] indices -> NHWC images in [0, 1]: the sigmoid of the first
        three output channels, unmapped."""
        out = self.graph.decode_pixels(img_seq)
        return self.unmap_pixels(torch.sigmoid(out[:, :3])).permute(0, 2, 3, 1)


class _VQGraph(_TensorGraph):
    """The taming VQGAN's encoder, quantizer and decoder over its state dict."""

    _USED_PREFIXES = ("encoder.", "decoder.", "quantize.", "quant_conv.", "post_quant_conv.")

    def __init__(self, state: dict, ddconfig: dict, is_gumbel: bool):
        super().__init__()
        self.ddconfig, self.is_gumbel = ddconfig, is_gumbel
        self._keep({k: v for k, v in state.items() if k.startswith(self._USED_PREFIXES)})

    def _norm(self, key, x):
        return F.group_norm(x, 32, self.p(f"{key}.weight").to(x.dtype),
                            self.p(f"{key}.bias").to(x.dtype), eps=1e-6)

    def _resnet(self, key, x):
        h = self.conv(f"{key}.conv1", _swish(self._norm(f"{key}.norm1", x)))
        h = self.conv(f"{key}.conv2", _swish(self._norm(f"{key}.norm2", h)))
        if self.has(f"{key}.nin_shortcut.weight"):
            x = self.conv(f"{key}.nin_shortcut", x)
        elif self.has(f"{key}.conv_shortcut.weight"):
            x = self.conv(f"{key}.conv_shortcut", x)
        return x + h

    def _attn(self, key, x):
        b, c, hh, ww = x.shape
        h = self._norm(f"{key}.norm", x)
        q, k, v = (self.conv(f"{key}.{n}", h).reshape(b, c, hh * ww) for n in ("q", "k", "v"))
        attn = torch.softmax(q.transpose(1, 2) @ k * (c ** -0.5), dim=-1)
        out = (v @ attn.transpose(1, 2)).reshape(b, c, hh, ww)
        return x + self.conv(f"{key}.proj_out", out)

    def encode_z(self, x):
        """NCHW images in [-1, 1] -> the latent grid NCHW."""
        dd = self.ddconfig
        ch_mult, num_res = tuple(dd["ch_mult"]), dd["num_res_blocks"]
        attn_res = set(dd.get("attn_resolutions", []))
        cur_res = dd["resolution"]
        h = self.conv("encoder.conv_in", x)
        for i in range(len(ch_mult)):
            for j in range(num_res):
                h = self._resnet(f"encoder.down.{i}.block.{j}", h)
                if cur_res in attn_res:
                    h = self._attn(f"encoder.down.{i}.attn.{j}", h)
            if i != len(ch_mult) - 1:
                h = self.conv(f"encoder.down.{i}.downsample.conv", h, stride=2, pad=(0, 1, 0, 1))
                cur_res //= 2
        h = self._resnet("encoder.mid.block_1", h)
        h = self._attn("encoder.mid.attn_1", h)
        h = self._resnet("encoder.mid.block_2", h)
        h = self.conv("encoder.conv_out", _swish(self._norm("encoder.norm_out", h)))
        if self.has("quant_conv.weight"):
            h = self.conv("quant_conv", h)
        return h

    def scores(self, z):
        """Latent grid NCHW -> [B, h*w, n_embed] scores whose argmax is the
        code: the Gumbel projection's logits, or minus the squared distance
        to each codebook entry."""
        b, c = z.shape[:2]
        if self.is_gumbel:
            logits = self.conv("quantize.proj", z)
            return logits.reshape(b, logits.shape[1], -1).transpose(1, 2)
        emb = self.p("quantize.embedding.weight").to(z.dtype)
        flat = z.reshape(b, c, -1).transpose(1, 2)
        d = (flat**2).sum(-1, keepdim=True) - 2 * flat @ emb.t() + (emb**2).sum(-1)
        return -d

    def decode_indices(self, indices):
        """Flat indices [B, n] -> NCHW images in [0, 1]."""
        dd = self.ddconfig
        emb = self.p("quantize.embed.weight" if self.is_gumbel else "quantize.embedding.weight")
        b, n = indices.shape
        hw = math.isqrt(n)
        z = emb[indices.long()].reshape(b, hw, hw, -1).permute(0, 3, 1, 2)
        ch_mult, num_res = tuple(dd["ch_mult"]), dd["num_res_blocks"]
        attn_res = set(dd.get("attn_resolutions", []))
        cur_res = dd["resolution"] // 2 ** (len(ch_mult) - 1)
        if self.has("post_quant_conv.weight"):
            z = self.conv("post_quant_conv", z)
        h = self.conv("decoder.conv_in", z)
        h = self._resnet("decoder.mid.block_1", h)
        h = self._attn("decoder.mid.attn_1", h)
        h = self._resnet("decoder.mid.block_2", h)
        for i in reversed(range(len(ch_mult))):
            for j in range(num_res + 1):
                h = self._resnet(f"decoder.up.{i}.block.{j}", h)
                if cur_res in attn_res:
                    h = self._attn(f"decoder.up.{i}.attn.{j}", h)
            if i != 0:
                h = self.conv(f"decoder.up.{i}.upsample.conv", _upsample2(h))
                cur_res *= 2
        h = self.conv("decoder.conv_out", _swish(self._norm("decoder.norm_out", h)))
        return (torch.clamp(h, -1.0, 1.0) + 1.0) * 0.5


def read_config(path: Path) -> dict:
    """A VQGAN config: JSON when it parses as JSON, else YAML (PyYAML)."""
    text = Path(path).read_text()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    try:
        import yaml
    except ImportError as exc:
        raise ImportError(
            f"{path} is not JSON, and reading it as YAML needs PyYAML, which is not "
            "installed here: write the config as JSON (a JSON document is also YAML)"
        ) from exc
    return yaml.safe_load(text)


class VQGanVAE(nn.Module):
    """A taming VQGAN from its checkpoint (a {"state_dict": ...} pickle)
    and its config; the geometry comes from the config's ddconfig."""

    channels = 3

    def __init__(self, vqgan_model_path: str, vqgan_config_path: str):
        super().__init__()
        model_path = _require(Path(vqgan_model_path), "VQGAN checkpoint")
        config = read_config(_require(Path(vqgan_config_path), "VQGAN config"))
        params = config["model"]["params"]
        self.ddconfig = params["ddconfig"]
        self.image_size = self.ddconfig["resolution"]
        self.num_layers = len(self.ddconfig["ch_mult"]) - 1  # log2 of the downsampling
        self.num_tokens = params["n_embed"]
        self.is_gumbel = "Gumbel" in config["model"]["target"]
        state = torch.load(model_path, map_location="cpu")["state_dict"]
        self.graph = _VQGraph(_state_dict(state), self.ddconfig, self.is_gumbel)

    @property
    def fmap_size(self) -> int:
        return self.image_size // (2**self.num_layers)

    def encode_scores(self, images: torch.Tensor) -> torch.Tensor:
        """NHWC images in [0, 1] -> [B, h*w, n_embed] quantizer scores."""
        with exact_float32():
            x = 2.0 * images.to(self.graph.p("encoder.conv_in.weight").dtype) - 1.0
            return self.graph.scores(self.graph.encode_z(x.permute(0, 3, 1, 2)))

    def get_codebook_indices(self, images: torch.Tensor) -> torch.Tensor:
        """NHWC images in [0, 1] -> [B, h*w] codebook indices."""
        return self.encode_scores(images).argmax(dim=-1)

    def decode(self, img_seq: torch.Tensor) -> torch.Tensor:
        """[B, n] indices -> NHWC images in [0, 1]."""
        return self.graph.decode_indices(img_seq).permute(0, 2, 3, 1)


def is_pretrained(vae) -> bool:
    """Whether `vae` is a pretrained wrapper (not a trained DiscreteVAE)."""
    return not isinstance(vae, DiscreteVAE)


def to_unit(vae, pixels: torch.Tensor) -> torch.Tensor:
    """Float32 pixels in [0, 1] from `vae`'s decode output: a DiscreteVAE
    decodes into its normalized space, which this maps back; the wrappers
    decode into [0, 1] already. Clamped either way."""
    pixels = pixels.float()
    return (pixels if is_pretrained(vae) else pixels * 0.5 + 0.5).clamp(0.0, 1.0)


def decode_unit(vae, img_seq: torch.Tensor) -> torch.Tensor:
    """NHWC pixels in [0, 1] of [B, n] indices, from any VAE (`to_unit`)."""
    return to_unit(vae, vae.decode(img_seq))
