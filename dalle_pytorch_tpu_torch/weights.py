"""Carry the JAX package's parameter trees into the port's modules, and
back out.

A tree is the reference's flax parameter tree (`variables["params"]`) as
nested dicts of numpy arrays, the layout `save_dalle_checkpoint` writes.
`export_dalle_params` is the exact inverse of `load_dalle_params` (float32
leaves, whatever the module's dtype), as is `export_clip_params` of
`load_clip_params`; `export_dvae_params` writes the decoder and carries
encoder leaves through. Mappings:

  * Dense kernel [in, out] -> Linear.weight [out, in];
  * Conv kernel HWIO -> Conv2d.weight OIHW;
  * ConvTranspose kernel HWIO -> ConvTranspose2d.weight [in, out, kh, kw],
    flipped in both spatial axes (flax's transpose_kernel=False);
  * LayerNorm scale -> weight.

Every leaf must be consumed and every port parameter filled: a missing or
extra leaf raises, naming it. The dVAE encoder leaves are checked by name
and not loaded (the port has the decoder only).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from dalle_pytorch_tpu_torch.models.clip import CLIP
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.models.dvae import DiscreteVAE
from dalle_pytorch_tpu_torch.models.transformer import Transformer

_Target = Tuple[torch.Tensor, Callable[[np.ndarray], np.ndarray]]


def _same(a):
    return a


def _dense_t(a):
    return a.T


def _conv_oihw(a):
    return a.transpose(3, 2, 0, 1)


def _conv_transpose(a):
    return a[::-1, ::-1].transpose(2, 3, 0, 1)


#: each mapping's inverse, for export (port layout -> reference layout)
_INVERSE = {
    _same: _same,
    _dense_t: _dense_t,
    _conv_oihw: lambda a: a.transpose(2, 3, 1, 0),
    _conv_transpose: lambda a: a.transpose(2, 3, 0, 1)[::-1, ::-1],
}


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, path + "/"))
        else:
            out[path] = np.asarray(val)
    return out


def _assign(targets: Dict[str, _Target], flat: Dict[str, np.ndarray], what: str) -> None:
    extra = sorted(set(flat) - set(targets))
    missing = sorted(set(targets) - set(flat))
    if extra or missing:
        raise ValueError(
            f"{what} tree does not match the port's module: "
            f"unconsumed leaves {extra}, missing leaves {missing}"
        )
    with torch.no_grad():
        for path, (param, fn) in targets.items():
            arr = np.array(fn(flat[path]), copy=True)  # writable, contiguous
            if tuple(arr.shape) != tuple(param.shape):
                raise ValueError(
                    f"{what} leaf {path}: shape {arr.shape} does not fit "
                    f"{tuple(param.shape)}"
                )
            param.copy_(torch.from_numpy(arr))


def _linear(prefix, lin, targets, bias=True):
    targets[f"{prefix}/kernel"] = (lin.weight, _dense_t)
    if bias:
        targets[f"{prefix}/bias"] = (lin.bias, _same)


def _norm(prefix, norm, targets):
    targets[f"{prefix}/scale"] = (norm.weight, _same)
    targets[f"{prefix}/bias"] = (norm.bias, _same)


def _conv(prefix, conv, targets, fn=_conv_oihw):
    targets[f"{prefix}/kernel"] = (conv.weight, fn)
    targets[f"{prefix}/bias"] = (conv.bias, _same)


def _unflatten(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, arr in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def _export_flat(targets: Dict[str, _Target]) -> Dict[str, np.ndarray]:
    """Inverse of `_assign`: every leaf in the reference layout, float32."""
    return {
        path: np.array(_INVERSE[fn](param.detach().float().cpu().numpy()), order="C")
        for path, (param, fn) in targets.items()
    }


def _dalle_targets(model: DALLE) -> Dict[str, _Target]:
    t: Dict[str, _Target] = {
        "text_emb/embedding": (model.text_emb.weight, _same),
        "image_emb/embedding": (model.image_emb.weight, _same),
    }
    if not model.rotary_emb:
        t["text_pos_emb/embedding"] = (model.text_pos_emb.weight, _same)
        t["image_pos_emb/rows"] = (model.image_pos_emb.rows, _same)
        t["image_pos_emb/cols"] = (model.image_pos_emb.cols, _same)
    _norm("logits_norm", model.logits_norm, t)
    if model.share_input_output_emb:
        t["logits_bias"] = (model.logits_bias, _same)
    else:
        _linear("logits_dense", model.logits_dense, t)
    _transformer_targets("transformer", model.transformer, t)
    return t


def _transformer_targets(prefix: str, tr: Transformer, t: Dict[str, _Target]) -> None:
    """The leaves of a reference `Transformer` (unrolled layout) under
    `prefix`."""
    for key, attn in tr.attn.items():
        _linear(f"{prefix}/attn_{key}/to_qkv", attn.to_qkv, t, bias=False)
        _linear(f"{prefix}/attn_{key}/to_out", attn.to_out, t)
    for key, ff in tr.ff.items():
        _linear(f"{prefix}/ff_{key}/Dense_0", ff.dense_0, t)
        _linear(f"{prefix}/ff_{key}/Dense_1", ff.dense_1, t)
    for i in range(tr.depth):
        _norm(f"{prefix}/attn_norms_{i}", tr.attn_norms[i], t)
        _norm(f"{prefix}/ff_norms_{i}", tr.ff_norms[i], t)
        if tr.sandwich_norm:
            _norm(f"{prefix}/attn_norms_out_{i}", tr.attn_norms_out[i], t)
            _norm(f"{prefix}/ff_norms_out_{i}", tr.ff_norms_out[i], t)
        t[f"{prefix}/attn_scale_{i}"] = (tr.attn_scales[i], _same)
        t[f"{prefix}/ff_scale_{i}"] = (tr.ff_scales[i], _same)


def load_dalle_params(model: DALLE, tree: dict) -> DALLE:
    """Load a reference DALLE parameter tree (unrolled executor layout)
    into `model` in place; returns the model."""
    if "scan_stack" in tree.get("transformer", {}):
        raise ValueError(
            "scan-layout DALLE tree (executor='scan'): the port loads the "
            "unrolled layout only; scan-layout checkpoints are the ROADMAP "
            "Queue 1 item 'scan-layout checkpoint loading'"
        )
    _assign(_dalle_targets(model), _flatten(tree), "DALLE")
    return model


def export_dalle_params(model: DALLE) -> dict:
    """The reference DALLE parameter tree (unrolled layout) of `model`."""
    return _unflatten(_export_flat(_dalle_targets(model)))


def _encoder_shapes(vae: DiscreteVAE) -> Dict[str, tuple]:
    """The reference encoder's leaves (flax HWIO kernels) and shapes."""
    hid, chans = vae.dec_head.in_channels, vae.dec_head.out_channels
    shapes = {}
    for i in range(vae.num_layers):
        shapes[f"enc_convs_{i}/kernel"] = (4, 4, chans if i == 0 else hid, hid)
        shapes[f"enc_convs_{i}/bias"] = (hid,)
    for i in range(vae.num_resnet_blocks):
        for j, k in enumerate((3, 3, 1)):
            shapes[f"enc_res_{i}/Conv_{j}/kernel"] = (k, k, hid, hid)
            shapes[f"enc_res_{i}/Conv_{j}/bias"] = (hid,)
    shapes["enc_head/kernel"] = (1, 1, hid, vae.num_tokens)
    shapes["enc_head/bias"] = (vae.num_tokens,)
    return shapes


def _dvae_decoder_targets(vae: DiscreteVAE) -> Dict[str, _Target]:
    t: Dict[str, _Target] = {"codebook/embedding": (vae.codebook.weight, _same)}
    if vae.dec_proj is not None:
        _conv("dec_proj", vae.dec_proj, t)
    for i, blk in enumerate(vae.dec_res):
        for j, conv in enumerate((blk.conv_0, blk.conv_1, blk.conv_2)):
            _conv(f"dec_res_{i}/Conv_{j}", conv, t)
    for i, conv in enumerate(vae.dec_convs):
        _conv(f"dec_convs_{i}", conv, t, fn=_conv_transpose)
    _conv("dec_head", vae.dec_head, t)
    return t


def load_dvae_params(vae: DiscreteVAE, tree: dict) -> DiscreteVAE:
    """Load a reference DiscreteVAE parameter tree's decoder into `vae` in
    place (encoder leaves must be present and are left unused)."""
    flat = _flatten(tree)
    for name in _encoder_shapes(vae):
        if name not in flat:
            raise ValueError(f"DiscreteVAE tree lacks encoder leaf {name}")
        del flat[name]
    _assign(_dvae_decoder_targets(vae), flat, "DiscreteVAE")
    return vae


def export_dvae_params(vae: DiscreteVAE, encoder: Optional[dict] = None) -> dict:
    """A reference DiscreteVAE tree: the port's decoder, plus the encoder
    leaves of `encoder` (a tree holding them, e.g. the one the decoder was
    loaded from). The port has no encoder, so without one the encoder
    leaves are written as zeros of the reference's shapes: such a tree
    decodes, and cannot encode."""
    flat = _export_flat(_dvae_decoder_targets(vae))
    given = _flatten(encoder) if encoder is not None else {}
    for name, shape in _encoder_shapes(vae).items():
        leaf = given.get(name, np.zeros(shape, np.float32))
        if tuple(leaf.shape) != shape:
            raise ValueError(f"encoder leaf {name}: shape {leaf.shape} != {shape}")
        flat[name] = leaf
    return _unflatten(flat)


def _clip_targets(clip: CLIP) -> Dict[str, _Target]:
    t: Dict[str, _Target] = {
        "text_emb/embedding": (clip.text_emb.weight, _same),
        "text_pos_emb/embedding": (clip.text_pos_emb.weight, _same),
        "visual_pos_emb/embedding": (clip.visual_pos_emb.weight, _same),
        "temperature": (clip.temperature, _same),
    }
    _linear("to_text_latent", clip.to_text_latent, t, bias=False)
    _linear("to_visual_embedding", clip.to_visual_embedding, t)
    _linear("to_visual_latent", clip.to_visual_latent, t, bias=False)
    _transformer_targets("text_transformer", clip.text_transformer, t)
    _transformer_targets("visual_transformer", clip.visual_transformer, t)
    return t


def load_clip_params(clip: CLIP, tree: dict) -> CLIP:
    """Load a reference CLIP parameter tree (unrolled layout) into `clip`
    in place; returns it."""
    if any("scan_stack" in tree.get(k, {}) for k in ("text_transformer", "visual_transformer")):
        raise ValueError(
            "scan-layout CLIP tree (executor='scan'): the port loads the unrolled "
            "layout only (ROADMAP Queue 1, scan-layout checkpoints)"
        )
    _assign(_clip_targets(clip), _flatten(tree), "CLIP")
    return clip


def export_clip_params(clip: CLIP) -> dict:
    """The reference CLIP parameter tree (unrolled layout) of `clip`."""
    return _unflatten(_export_flat(_clip_targets(clip)))
