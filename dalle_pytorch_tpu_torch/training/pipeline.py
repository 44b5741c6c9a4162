"""Models from a checkpoint's metadata, and the DALLE checkpoint loader.

Counterparts of the JAX package's `training/pipeline.py:dalle_from_config`,
`dvae_from_hparams` and `load_dalle_checkpoint`, reading the plain dicts
stored in the checkpoint's metadata (the `config` dict of the training
config, the `vae_hparams` dict) instead of config dataclasses.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.models.dvae import DiscreteVAE
from dalle_pytorch_tpu_torch.training.checkpoint import load_params_npz


def _csv(spec) -> Tuple[str, ...]:
    return tuple(s.strip() for s in str(spec).split(",") if s.strip())


def _ids(spec) -> Optional[Tuple[int, ...]]:
    return tuple(int(s) for s in _csv(spec)) if spec else None


def dalle_from_config(
    config: dict, num_image_tokens: int, image_fmap_size: int, vocab_size: int
) -> Tuple[DALLE, torch.dtype]:
    """(DALLE, its dtype) from a checkpoint's `config` dict.

    Decode never runs the training-only attention layouts: "ring" and the
    library kernel ("lib_flash") decode through "auto" and "dense", as in
    the reference's cached path.
    """
    m = config["model"]
    if m.get("reversible") and m.get("reversible_impl", "remat") != "remat":
        raise NotImplementedError(
            "reversible_impl='revnet' decodes two-stream; not ported yet"
        )
    attn_impl = {"ring": "auto", "lib_flash": "dense"}.get(
        m.get("attn_impl", "auto"), m.get("attn_impl", "auto")
    )
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
    )
    return model, torch.bfloat16 if config.get("bf16", True) else torch.float32


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
