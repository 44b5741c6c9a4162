"""Models and tokenizers from a checkpoint's metadata, and the DALLE and
CLIP checkpoint writers and loaders.

Counterparts of the JAX package's `training/pipeline.py:build_tokenizer`,
`dalle_from_config`, `dvae_from_hparams`, `save_dalle_checkpoint`,
`load_dalle_checkpoint`, `clip_hparams`, `save_clip_checkpoint` and
`load_clip_checkpoint`,
with the plain dicts stored in the checkpoint's metadata (the `config`
dict of the training config, the `vae_hparams` dict) in place of config
dataclasses. `dalle_config` builds that dict from a port DALLE, with only
keys the reference's config knows, so a checkpoint written here loads in
the JAX package's `load_dalle_checkpoint` as well as in the port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dalle_pytorch_tpu_torch import __version__
from dalle_pytorch_tpu_torch.data.tokenizer import get_tokenizer
from dalle_pytorch_tpu_torch.models.clip import CLIP
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.models.dvae import DiscreteVAE
from dalle_pytorch_tpu_torch.training.checkpoint import load_params_npz, save_params_npz
from dalle_pytorch_tpu_torch.weights import export_clip_params, export_dalle_params, load_clip_params


def _csv(spec) -> Tuple[str, ...]:
    return tuple(s.strip() for s in str(spec).split(",") if s.strip())


def _ids(spec) -> Optional[Tuple[int, ...]]:
    return tuple(int(s) for s in _csv(spec)) if spec else None


def build_tokenizer(config: dict):
    """The tokenizer a checkpoint's `config` names by the trainer's flags
    (`bpe_path`, `hug`, `chinese`, `yttm`, `native`), or the default
    vocabulary when it names none (`data/tokenizer.py:get_tokenizer`)."""
    return get_tokenizer(
        bpe_path=config.get("bpe_path"), hug=config.get("hug", False),
        chinese=config.get("chinese", False), yttm=config.get("yttm", False),
        native=config.get("native", False),
    )


def dalle_from_config(
    config: dict, num_image_tokens: int, image_fmap_size: int, vocab_size: int
) -> Tuple[DALLE, torch.dtype]:
    """(DALLE, its dtype) from a checkpoint's `config` dict, for decoding or
    training.

    `attn_impl` keeps "flash", "auto", "dense" and "lib_flash" (the
    reference's library kernel: the port trains such a model through its
    own flash kernels and decodes it dense, as the reference decodes it;
    see `models/attention.py`). The sequence-parallel "ring" (a multi-card
    training layout) maps to "auto". `reversible_impl="revnet"` is not
    ported and raises.
    """
    m = config["model"]
    attn_impl = m.get("attn_impl", "auto")
    attn_impl = "auto" if attn_impl == "ring" else attn_impl
    model = DALLE(
        dim=m["dim"],
        depth=m["depth"],
        heads=m["heads"],
        dim_head=m["dim_head"],
        num_image_tokens=num_image_tokens,
        image_fmap_size=image_fmap_size,
        num_text_tokens=vocab_size,
        text_seq_len=m["text_seq_len"],
        attn_types=_csv(m.get("attn_types", "full")),
        stable=m.get("stable_softmax", False),
        sandwich_norm=m.get("sandwich_norm", False),
        shift_tokens=m.get("shift_tokens", False),
        rotary_emb=m.get("rotary_emb", False),
        shared_attn_ids=_ids(m.get("shared_attn_ids")),
        shared_ff_ids=_ids(m.get("shared_ff_ids")),
        share_input_output_emb=m.get("share_input_output_emb", False),
        attn_impl=attn_impl,
        reversible=m.get("reversible", False),
        reversible_impl=m.get("reversible_impl", "remat"),
        attn_dropout=m.get("attn_dropout", 0.0),
        ff_dropout=m.get("ff_dropout", 0.0),
        loss_img_weight=m.get("loss_img_weight", 7.0),
        text_loss_coeff=config.get("text_loss_coeff", 1.0),
        img_loss_coeff=config.get("img_loss_coeff", 7.0),
        text_loss_coeff_inv=config.get("text_loss_coeff_inv", 7.0),
        img_loss_coeff_inv=config.get("img_loss_coeff_inv", 1.0),
        fused_ce=m.get("fused_ce", False),
    )
    return model, torch.bfloat16 if config.get("bf16", True) else torch.float32


def dalle_config(model: DALLE, bf16: bool = True, mode: str = "forward_only") -> dict:
    """The checkpoint `config` dict describing `model`, in the reference
    config's key names (a subset of its `TrainConfig`)."""
    tr = model.transformer
    return {
        "mode": mode,
        "bf16": bf16,
        "text_loss_coeff": model.text_loss_coeff,
        "img_loss_coeff": model.img_loss_coeff,
        "text_loss_coeff_inv": model.text_loss_coeff_inv,
        "img_loss_coeff_inv": model.img_loss_coeff_inv,
        "model": {
            "dim": model.dim,
            "depth": model.depth,
            "heads": model.heads,
            "dim_head": model.dim_head,
            "text_seq_len": model.text_seq_len,
            "num_text_tokens": model.num_text_tokens,
            "attn_types": ",".join(model.attn_types),
            "shift_tokens": model.shift_tokens,
            "rotary_emb": model.rotary_emb,
            "stable_softmax": model.stable,
            "sandwich_norm": tr.sandwich_norm,
            "share_input_output_emb": model.share_input_output_emb,
            "shared_attn_ids": _join(model.shared_attn_ids),
            "shared_ff_ids": _join(model.shared_ff_ids),
            "reversible": tr.reversible,
            "attn_dropout": model.attn_dropout,
            "ff_dropout": model.ff_dropout,
            "fused_ce": model.fused_ce,
            "attn_impl": model.attn_impl,
        },
    }


def _join(ids) -> Optional[str]:
    return None if ids is None else ",".join(str(i) for i in ids)


def save_dalle_checkpoint(
    path: str,
    config: dict,
    model: DALLE,
    vae_params: Optional[dict] = None,
    epoch: int = 0,
    vae_class_name: str = "DiscreteVAE",
    vae_hparams: Optional[dict] = None,
    train_meta: Optional[dict] = None,
) -> None:
    """Write `model` as the reference's single-file DALLE checkpoint: the
    DALLE tree (and `vae_params`, a reference dVAE tree, when given) with
    the metadata {type, version, epoch, vae_class_name, vae_hparams,
    config, train}. The optimizer state is not written (the reference's
    optional `opt` leaves follow optax's layout)."""
    trees = {"dalle": export_dalle_params(model)}
    if vae_params is not None:
        trees["vae"] = vae_params
    save_params_npz(
        path,
        trees,
        metadata={
            "type": "DALLE",
            "version": __version__,
            "epoch": epoch,
            "vae_class_name": vae_class_name,
            "vae_hparams": vae_hparams,
            "config": config,
            "train": train_meta or {},
        },
    )


def dvae_hparams(vae: DiscreteVAE) -> dict:
    """The checkpoint `vae_hparams` dict of a port DiscreteVAE."""
    return {
        "image_size": vae.image_size,
        "num_tokens": vae.num_tokens,
        "codebook_dim": vae.codebook.embedding_dim,
        "num_layers": vae.num_layers,
        "num_resnet_blocks": vae.num_resnet_blocks,
        "hidden_dim": vae.dec_head.in_channels,
        "channels": vae.dec_head.out_channels,
    }


def dvae_from_hparams(h: dict) -> DiscreteVAE:
    return DiscreteVAE(
        image_size=h["image_size"],
        num_tokens=h["num_tokens"],
        codebook_dim=h["codebook_dim"],
        num_layers=h["num_layers"],
        num_resnet_blocks=h.get("num_resnet_blocks", 0),
        hidden_dim=h["hidden_dim"],
        channels=h.get("channels", 3),
    )


def load_dalle_checkpoint(path: str):
    """Returns (config dict, dalle tree, vae tree or None, metadata)."""
    params, meta = load_params_npz(path)
    if meta.get("type") != "DALLE":
        raise ValueError(f"{path} is not a DALLE checkpoint")
    return meta["config"], params["dalle"], params.get("vae"), meta


def clip_hparams(clip: CLIP) -> dict:
    """The checkpoint `clip_hparams` dict of a port CLIP (the reference's
    keys; the port's layers are the unrolled executor's)."""
    return {
        "dim_text": clip.dim_text,
        "dim_image": clip.dim_image,
        "dim_latent": clip.dim_latent,
        "num_text_tokens": clip.num_text_tokens,
        "text_enc_depth": clip.text_enc_depth,
        "text_seq_len": clip.text_seq_len,
        "text_heads": clip.text_heads,
        "num_visual_tokens": clip.num_visual_tokens,
        "visual_enc_depth": clip.visual_enc_depth,
        "visual_heads": clip.visual_heads,
        "visual_image_size": clip.visual_image_size,
        "visual_patch_size": clip.visual_patch_size,
        "channels": clip.channels,
        "executor": "unrolled",
    }


def save_clip_checkpoint(path: str, clip: CLIP) -> None:
    """The reference's single-file CLIP checkpoint: the CLIP tree and the
    `clip_hparams` metadata."""
    save_params_npz(path, export_clip_params(clip), metadata={"clip_hparams": clip_hparams(clip)})


def load_clip_checkpoint(path: str) -> CLIP:
    """A float32 CLIP with the checkpoint's weights, on the CPU."""
    params, metadata = load_params_npz(path)
    hparams = dict(metadata["clip_hparams"])
    executor = hparams.pop("executor", "unrolled")
    if executor != "unrolled":
        raise ValueError(
            f"CLIP checkpoint of executor {executor!r}: the port loads the unrolled "
            "layout only (ROADMAP Queue 1, scan-layout checkpoints)"
        )
    return load_clip_params(CLIP(**hparams), params)
