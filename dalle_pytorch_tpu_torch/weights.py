"""Carry the JAX package's parameter trees into the port's modules, and
back out.

A tree is the reference's flax parameter tree (`variables["params"]`) as
nested dicts of numpy arrays, the layout `save_dalle_checkpoint` writes.
`export_dalle_params` is the exact inverse of `load_dalle_params` (float32
leaves, whatever the module's dtype), as are `export_clip_params` of
`load_clip_params` and `export_dvae_params` of `load_dvae_params` (the
encoder and the decoder). Mappings:

  * Dense kernel [in, out] -> Linear.weight [out, in];
  * Conv kernel HWIO -> Conv2d.weight OIHW;
  * ConvTranspose kernel HWIO -> ConvTranspose2d.weight [in, out, kh, kw],
    flipped in both spatial axes (flax's transpose_kernel=False);
  * LayerNorm scale -> weight.

Every leaf must be consumed and every port parameter filled: a missing or
extra leaf raises, naming it.

Layouts: a DALLE or CLIP tree comes in the unrolled executor's layout
(`attn_{i}`, `ff_{i}`, ... per layer) or in the scan executor's
(`scan_stack/layers/...` with [depth, ...] leaves; the JAX package's
`executor="scan"`). The loaders take either, converting the scan layout
(`models/transformer.py:scan_params_to_unrolled`); the exporters write
`layout="unrolled"` (the default) or `layout="scan"`, which they refuse,
with the JAX package's reason, for a model its scan executor does not run.

The DALLE optimizer's state travels as the reference's `opt` leaves
(`export_dalle_opt_state`, `load_dalle_opt_state`): the optax state of
`inject_hyperparams(chain(clip_by_global_norm, adam))` flattened in
`jax.tree_util` order, which is the update count (int32), the learning
rate (float32), Adam's count (int32), then Adam's first moments `mu` and
second moments `nu`, each over the DALLE tree in sorted-key order. Each
moment takes its weight's layout conversion, and in the scan layout the
moments are stacked as the weights are and follow the scan tree's order.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from dalle_pytorch_tpu_torch.models.clip import CLIP
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.models.dvae import DiscreteVAE
from dalle_pytorch_tpu_torch.models.transformer import (
    Transformer,
    check_scan_supported,
    scan_params_to_unrolled,
    unrolled_params_to_scan,
)

LAYOUTS = ("unrolled", "scan")

_Target = Tuple[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]

# the mappings (reference layout -> port layout) act on tensors, on the
# parameter's device, so a card transposes its own weights


def _same(a):
    return a


def _dense_t(a):
    return a.t()


def _conv_oihw(a):
    return a.permute(3, 2, 0, 1)


def _conv_transpose(a):
    return a.flip(0, 1).permute(2, 3, 0, 1)


#: each mapping's inverse, for export (port layout -> reference layout)
_INVERSE = {
    _same: _same,
    _dense_t: _dense_t,
    _conv_oihw: lambda a: a.permute(2, 3, 1, 0),
    _conv_transpose: lambda a: a.permute(2, 3, 0, 1).flip(0, 1),
}


def _to_port(leaf: np.ndarray, param: torch.Tensor, fn) -> torch.Tensor:
    """A reference-layout leaf in `param`'s layout, on its device."""
    return fn(torch.tensor(np.asarray(leaf)).to(param.device))


def _to_reference(tensor: torch.Tensor, fn) -> np.ndarray:
    """A port-layout tensor as a float32 reference-layout numpy leaf: a
    copy, never a view of the tensor (a checkpoint written in the
    background must not see the next step's updates)."""
    leaf = _INVERSE[fn](tensor.detach().float()).contiguous()
    return leaf.to("cpu", copy=True).numpy()


def _flatten(tree, prefix: str = "", leaf=np.asarray) -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, path + "/", leaf))
        else:
            out[path] = leaf(val)
    return out


def _path_key(path: str) -> tuple:
    """`jax.tree_util`'s leaf order of a tree: keys sorted at every level."""
    return tuple(path.split("/"))


def _check_layout(layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; one of {LAYOUTS}")


def _is_scan(tree: dict, transformers: Dict[str, Transformer]) -> bool:
    return any("scan_stack" in tree.get(k, {}) for k in transformers)


def _unrolled(tree: dict, transformers: Dict[str, Transformer]) -> dict:
    """`tree` with each transformer subtree in the unrolled layout."""
    if not _is_scan(tree, transformers):
        return tree
    out = dict(tree)
    for key, tr in transformers.items():
        out[key] = scan_params_to_unrolled(tree[key], tr.depth)
    return out


def _in_layout(tree: dict, transformers: Dict[str, Transformer], layout: str,
               stack=np.stack) -> dict:
    """An unrolled `tree` in `layout`; the scan layout is refused, with the
    JAX package's reason, for a stack its scan executor does not run."""
    _check_layout(layout)
    if layout == "unrolled":
        return tree
    out = dict(tree)
    for key, tr in transformers.items():
        check_scan_supported(**tr.scan_config)
        out[key] = unrolled_params_to_scan(tree[key], tr.depth, stack)
    return out


def _stack_shapes(shapes):
    return (len(shapes),) + tuple(shapes[0])


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
            value = _to_port(flat[path], param, fn)
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(
                    f"{what} leaf {path}: shape {tuple(value.shape)} does not fit "
                    f"{tuple(param.shape)}"
                )
            param.copy_(value)


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
    return {path: _to_reference(param, fn) for path, (param, fn) in targets.items()}


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


def _dalle_stacks(model: DALLE) -> Dict[str, Transformer]:
    return {"transformer": model.transformer}


def load_dalle_params(model: DALLE, tree: dict) -> DALLE:
    """Load a reference DALLE parameter tree (either layout) into `model`
    in place; returns the model."""
    tree = _unrolled(tree, _dalle_stacks(model))
    _assign(_dalle_targets(model), _flatten(tree), "DALLE")
    return model


def dalle_tree_layout(tree: dict) -> str:
    """The layout of a reference DALLE tree: "scan" or "unrolled"."""
    return "scan" if "scan_stack" in tree.get("transformer", {}) else "unrolled"


def export_dalle_params(model: DALLE, layout: str = "unrolled") -> dict:
    """The reference DALLE parameter tree of `model` in `layout` (a model
    split over fsdp: inside `parallel/fsdp.py:gathered(model)`, a
    collective, so the tree holds full tensors at any world size)."""
    tree = _unflatten(_export_flat(_dalle_targets(model)))
    return _in_layout(tree, _dalle_stacks(model), layout)


def shard_dalle_params(model: DALLE, mesh, model_axis: str = "tp") -> List[Dict[str, torch.Tensor]]:
    """A DALLE's parameters (as `load_dalle_params` put them into it) cut
    into one {name: tensor} per shard along `model_axis` of `mesh`, by
    `parallel/partition.py`'s rules: a split tensor gives each shard its
    piece (a view), a replicated one the whole tensor."""
    from dalle_pytorch_tpu_torch.parallel.partition import partition_params, split_tensor

    n = len(mesh.axis_devices(model_axis))
    placements = partition_params(model, mesh)
    out: List[Dict[str, torch.Tensor]] = [{} for _ in range(n)]
    for name, tensor in model.state_dict().items():
        for s, piece in enumerate(split_tensor(tensor, placements[name], n, model_axis)):
            out[s][name] = piece
    return out


def _dvae_targets(vae: DiscreteVAE) -> Dict[str, _Target]:
    t: Dict[str, _Target] = {"codebook/embedding": (vae.codebook.weight, _same)}
    for i, conv in enumerate(vae.enc_convs):
        _conv(f"enc_convs_{i}", conv, t)
    for prefix, blocks in (("enc_res", vae.enc_res), ("dec_res", vae.dec_res)):
        for i, blk in enumerate(blocks):
            for j, conv in enumerate((blk.conv_0, blk.conv_1, blk.conv_2)):
                _conv(f"{prefix}_{i}/Conv_{j}", conv, t)
    _conv("enc_head", vae.enc_head, t)
    if vae.dec_proj is not None:
        _conv("dec_proj", vae.dec_proj, t)
    for i, conv in enumerate(vae.dec_convs):
        _conv(f"dec_convs_{i}", conv, t, fn=_conv_transpose)
    _conv("dec_head", vae.dec_head, t)
    return t


def load_dvae_params(vae: DiscreteVAE, tree: dict) -> DiscreteVAE:
    """Load a reference DiscreteVAE parameter tree (encoder and decoder)
    into `vae` in place; returns it."""
    _assign(_dvae_targets(vae), _flatten(tree), "DiscreteVAE")
    return vae


def export_dvae_params(vae: DiscreteVAE) -> dict:
    """The reference DiscreteVAE parameter tree of `vae`."""
    return _unflatten(_export_flat(_dvae_targets(vae)))


def _opt_paths(model: DALLE, layout: str) -> List[Tuple[str, tuple]]:
    """(path, shape) of each moment leaf of `model` in `layout`, in
    `jax.tree_util`'s leaf order."""
    shapes = {
        path: tuple(_INVERSE[fn](torch.empty(param.shape, device="meta")).shape)
        for path, (param, fn) in _dalle_targets(model).items()
    }
    tree = _in_layout(_unflatten(shapes), _dalle_stacks(model), layout, stack=_stack_shapes)
    return sorted(_flatten(tree, leaf=tuple).items(), key=lambda kv: _path_key(kv[0]))


def dalle_opt_shapes(model: DALLE, layout: str = "unrolled") -> List[tuple]:
    """The shapes of the optimizer leaves of `model` (as exported in
    `layout`)."""
    moments = [shape for _, shape in _opt_paths(model, layout)]
    return [(), (), ()] + moments + moments


def export_dalle_opt_state(model: DALLE, optimizer, layout: str = "unrolled") -> List[np.ndarray]:
    """The reference's optimizer leaves of `optimizer` (a
    `training/steps.py:Optimizer` over `model`'s parameters), its moments
    in `layout`. A model split over fsdp exports its full moments inside
    `parallel/fsdp.py:gathered(model, optimizer)` (a collective; rank 0
    writes)."""
    from dalle_pytorch_tpu_torch.training.steps import get_learning_rate

    state = optimizer.adam.state
    targets = _dalle_targets(model)
    count = max((int(state[p]["step"]) for p, _ in targets.values() if p in state), default=0)
    moments = []
    for key in ("exp_avg", "exp_avg_sq"):
        flat = {
            path: _to_reference(state[param][key] if param in state else torch.zeros_like(param), fn)
            for path, (param, fn) in targets.items()
        }
        tree = _in_layout(_unflatten(flat), _dalle_stacks(model), layout)
        moments += [leaf for _, leaf in sorted(_flatten(tree).items(), key=lambda kv: _path_key(kv[0]))]
    return [np.asarray(count, np.int32), np.asarray(get_learning_rate(optimizer), np.float32),
            np.asarray(count, np.int32)] + moments


def load_dalle_opt_state(
    model: DALLE, optimizer, leaves: Sequence[np.ndarray], layout: str = "unrolled"
) -> None:
    """Set `optimizer`'s Adam state and learning rate from the reference's
    optimizer leaves, their moments in `layout` (the inverse of
    `export_dalle_opt_state`)."""
    from dalle_pytorch_tpu_torch.training.steps import set_learning_rate

    paths = [path for path, _ in _opt_paths(model, layout)]
    n = len(paths)
    if len(leaves) != 3 + 2 * n:
        raise ValueError(f"{len(leaves)} optimizer leaves, expected {3 + 2 * n}")
    count = int(leaves[2])
    set_learning_rate(optimizer, float(leaves[1]))
    optimizer.adam.state.clear()
    if count == 0:
        return
    stacks = _dalle_stacks(model)
    mu, nu = (
        _flatten(_unrolled(_unflatten(dict(zip(paths, part))), stacks))
        for part in (leaves[3 : 3 + n], leaves[3 + n :])
    )
    for path, (param, fn) in _dalle_targets(model).items():
        entry = {"step": torch.tensor(float(count), dtype=torch.float32)}
        for key, moments in (("exp_avg", mu), ("exp_avg_sq", nu)):
            value = _to_port(np.asarray(moments[path], np.float32), param, fn)
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"optimizer leaf {key} of {path}: shape {tuple(value.shape)} "
                                 f"does not fit {tuple(param.shape)}")
            entry[key] = value.to(param.dtype).contiguous()
        optimizer.adam.state[param] = entry


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


def _clip_stacks(clip: CLIP) -> Dict[str, Transformer]:
    return {"text_transformer": clip.text_transformer,
            "visual_transformer": clip.visual_transformer}


def load_clip_params(clip: CLIP, tree: dict) -> CLIP:
    """Load a reference CLIP parameter tree (either layout) into `clip` in
    place; returns it."""
    tree = _unrolled(tree, _clip_stacks(clip))
    _assign(_clip_targets(clip), _flatten(tree), "CLIP")
    return clip


def export_clip_params(clip: CLIP, layout: str = "unrolled") -> dict:
    """The reference CLIP parameter tree of `clip` in `layout`."""
    return _in_layout(_unflatten(_export_flat(_clip_targets(clip))), _clip_stacks(clip), layout)
