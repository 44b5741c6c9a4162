"""Models, tokenizers and datasets from a config, and the DALLE, dVAE
and CLIP checkpoint writers and loaders.

Counterparts of the JAX package's `training/pipeline.py:build_tokenizer`,
`build_dataset`, `vae_from_config`, `dvae_hparams`, `dvae_from_hparams`,
`save_vae_checkpoint`, `load_vae_checkpoint`, `build_vae`,
`dalle_from_config`, `save_dalle_checkpoint`, `load_dalle_checkpoint`,
`restore_opt_state`, `clip_hparams`, `save_clip_checkpoint` and
`load_clip_checkpoint`. The model builders take the plain dicts a
checkpoint's metadata stores (the `config` dict of the training config,
`training/config.py:config_to_dict`, and the `vae_hparams` dict) in
place of config dataclasses. `dalle_config` builds that dict from a port
DALLE, with only keys the reference's config knows, so a checkpoint
written here loads in the JAX package's `load_dalle_checkpoint` as well
as in the port. The port's modules hold their weights: the loaders
return modules, and the writers read the weights from them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from dalle_pytorch_tpu_torch import __version__
from dalle_pytorch_tpu_torch.data.tokenizer import get_tokenizer
from dalle_pytorch_tpu_torch.models import vae_io
from dalle_pytorch_tpu_torch.models.clip import CLIP
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.models.dvae import DiscreteVAE
from dalle_pytorch_tpu_torch.models.transformer import check_scan_supported
from dalle_pytorch_tpu_torch.training.checkpoint import load_params_npz, save_params_npz
from dalle_pytorch_tpu_torch.weights import (
    dalle_opt_shapes,
    export_clip_params,
    export_dalle_params,
    export_dvae_params,
    load_clip_params,
    load_dalle_opt_state,
    load_dvae_params,
)


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


def build_dataset(cfg, tokenizer, image_size: int):
    """The dataset `cfg` names (a `TrainConfig`): tar shards with
    `cfg.wds` ("image_key,text_key"), the seeded rainbow set for
    "rainbow[:N]" (N samples, 1024 by default; also when no folder is
    given), else a `TextImageDataset` over the folder."""
    if cfg.wds:
        from dalle_pytorch_tpu_torch.data.webdataset import TarImageTextDataset

        cols = [c.strip() for c in cfg.wds.split(",")]
        img_key, txt_key = (cols + ["jpg", "txt"])[:2]
        if not cfg.image_text_folder:
            raise ValueError("--image_text_folder must point at the tar shards")
        return TarImageTextDataset(
            cfg.image_text_folder,
            image_key=img_key,
            text_key=txt_key,
            text_len=cfg.model.text_seq_len,
            image_size=image_size,
            truncate_captions=cfg.truncate_captions,
            resize_ratio=cfg.resize_ratio,
            tokenizer=tokenizer,
        )
    folder = cfg.image_text_folder or "rainbow"
    if folder.startswith("rainbow"):
        n = int(folder.split(":")[1]) if ":" in folder else 1024
        return RainbowBatches(n, image_size, tokenizer, cfg.model.text_seq_len)
    from dalle_pytorch_tpu_torch.data.loader import TextImageDataset

    return TextImageDataset(
        folder,
        text_len=cfg.model.text_seq_len,
        image_size=image_size,
        truncate_captions=cfg.truncate_captions,
        resize_ratio=cfg.resize_ratio,
        tokenizer=tokenizer,
        class_name_json=cfg.class_name_json,
    )


class RainbowBatches:
    """A `RainbowDataset` with the datasets' `batches` signature (its
    tokenizer and text length bound)."""

    def __init__(self, num_samples: int, image_size: int, tokenizer, text_seq_len: int):
        from dalle_pytorch_tpu_torch.data.rainbow import RainbowDataset

        self.ds = RainbowDataset(num_samples=num_samples, image_size=image_size)
        self.tokenizer, self.text_seq_len = tokenizer, text_seq_len

    def __len__(self):
        return len(self.ds)

    def batches(self, batch_size, shuffle_seed=None, shard=(0, 1), **kw):
        return self.ds.batches(batch_size, self.tokenizer, self.text_seq_len,
                               shuffle_seed=shuffle_seed, shard=shard, **kw)


def dalle_from_config(
    config: dict, num_image_tokens: int, image_fmap_size: int, vocab_size: int, sp_mesh=None
) -> Tuple[DALLE, torch.dtype]:
    """(DALLE, its dtype) from a checkpoint's `config` dict, for decoding or
    training.

    `attn_impl` keeps "flash", "auto", "dense" and "lib_flash" (the
    reference's library kernel: the port trains such a model through its
    own flash kernels and decodes it dense, as the reference decodes it;
    see `models/attention.py`). The sequence-parallel "ring" (a multi-card
    training layout) runs over `sp_mesh` (the trainer's `TrainMesh`); with
    none (decoding a ring-trained checkpoint) it maps to "auto". `reversible_impl` "remat", "revnet"
    and "revnet_naive" build their executors. `executor="scan"` names the
    layout of the checkpoints (`checkpoint_layout`): the port's modules
    are the unrolled executor's either way.
    """
    m = config["model"]
    checkpoint_layout(config)
    attn_impl = m.get("attn_impl", "auto")
    attn_impl = "auto" if attn_impl == "ring" and sp_mesh is None else attn_impl
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
        sp_mesh=sp_mesh if attn_impl == "ring" else None,
    )
    return model, torch.bfloat16 if config.get("bf16", True) else torch.float32


def checkpoint_layout(config: dict) -> str:
    """The parameter layout a checkpoint of `config` is written in: its
    `model.executor`, "unrolled" or "scan". A model the JAX scan executor
    does not run is refused under "scan", with the JAX package's reason."""
    m = config["model"]
    executor = m.get("executor", "unrolled")
    if executor not in ("unrolled", "scan"):
        raise ValueError(f"unknown model.executor {executor!r}; valid: unrolled, scan")
    if executor == "scan":
        check_scan_supported(
            attn_types=_csv(m.get("attn_types", "full")), attn_impl=m.get("attn_impl", "auto"),
            shared_attn_ids=_ids(m.get("shared_attn_ids")), shared_ff_ids=_ids(m.get("shared_ff_ids")),
            reversible=m.get("reversible", False), reversible_impl=m.get("reversible_impl", "remat"),
        )
    return executor


def dalle_config(model: DALLE, bf16: bool = True, mode: str = "forward_only") -> dict:
    """The checkpoint `config` dict describing `model`, in the reference
    config's key names (a subset of its `TrainConfig`), its checkpoints in
    the unrolled layout."""
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
            "reversible_impl": tr.reversible_impl,
            "executor": "unrolled",
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
    opt_state: Optional[Sequence[np.ndarray]] = None,
) -> None:
    """Write `model` as the reference's single-file DALLE checkpoint: the
    DALLE tree (and `vae_params`, a reference dVAE tree, when given) with
    the metadata {type, version, epoch, vae_class_name, vae_hparams,
    config, train}, in the layout `config` names (`checkpoint_layout`);
    `opt_state`, the optimizer's leaves in that layout
    (`weights.py:export_dalle_opt_state`), goes in as the `opt` tree, as
    the reference writes it."""
    trees = {"dalle": export_dalle_params(model, checkpoint_layout(config))}
    if vae_params is not None:
        trees["vae"] = vae_params
    if opt_state is not None:
        trees["opt"] = opt_tree(opt_state)
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


def opt_tree(leaves: Sequence[np.ndarray]) -> dict:
    """Optimizer leaves -> the checkpoint's `opt` tree ("0000", "0001", ...)."""
    return {f"{i:04d}": np.asarray(leaf) for i, leaf in enumerate(leaves)}


def opt_leaves(tree: dict) -> List[np.ndarray]:
    """The checkpoint's `opt` tree -> its leaves, in numeric order."""
    return [tree[k] for k in sorted(tree, key=int)]


_DVAE_TRAIN_HPARAMS = ("smooth_l1_loss", "temperature", "straight_through", "reinmax",
                       "kl_div_loss_weight")


def dvae_hparams(vae: DiscreteVAE) -> dict:
    """The checkpoint `vae_hparams` dict of a port DiscreteVAE (the
    reference's keys)."""
    keys = ("image_size", "num_tokens", "codebook_dim", "num_layers", "num_resnet_blocks",
            "hidden_dim", "channels") + _DVAE_TRAIN_HPARAMS
    return {k: getattr(vae, k) for k in keys}


def dvae_from_hparams(h: dict) -> DiscreteVAE:
    defaults = dict(num_resnet_blocks=0, channels=3, smooth_l1_loss=False, temperature=0.9,
                    straight_through=False, reinmax=False, kl_div_loss_weight=0.0)
    return DiscreteVAE(**{**defaults, **h})


def vae_from_config(vcfg) -> DiscreteVAE:
    """A DiscreteVAE from a `VaeConfig` (random weights)."""
    return DiscreteVAE(
        image_size=vcfg.image_size,
        num_tokens=vcfg.num_tokens,
        codebook_dim=vcfg.codebook_dim,
        num_layers=vcfg.num_layers,
        num_resnet_blocks=vcfg.num_resnet_blocks,
        hidden_dim=vcfg.hidden_dim,
        channels=vcfg.channels,
        smooth_l1_loss=vcfg.smooth_l1_loss,
        temperature=vcfg.temperature,
        straight_through=vcfg.straight_through,
        reinmax=vcfg.reinmax,
        kl_div_loss_weight=vcfg.kl_loss_weight,
    )


def save_vae_checkpoint(path: str, vae: DiscreteVAE, epoch: int = 0) -> None:
    """The reference's single-file dVAE checkpoint: the tree and
    {type, version, epoch, hparams}."""
    save_params_npz(
        path,
        export_dvae_params(vae),
        metadata={"type": "DiscreteVAE", "version": __version__, "epoch": epoch,
                  "hparams": dvae_hparams(vae)},
    )


def load_vae_checkpoint(path: str) -> DiscreteVAE:
    """A float32 DiscreteVAE with the checkpoint's weights, on the CPU."""
    params, meta = load_params_npz(path)
    if meta.get("type") != "DiscreteVAE":
        raise ValueError(f"{path} is not a dVAE checkpoint")
    return load_dvae_params(dvae_from_hparams(meta["hparams"]), params)


def build_vae(cfg):
    """The trainer's VAE, in the reference's order: the trained dVAE at
    `vae_path`, else the VQGAN (`taming`, from `vqgan_model_path` and
    `vqgan_config_path`), else OpenAI's pretrained dVAE from
    `models/vae_io.py:CACHE_PATH`. `cfg` is a `TrainConfig` or a
    checkpoint's config dict."""
    def field(name):
        return cfg.get(name) if isinstance(cfg, dict) else getattr(cfg, name)

    if field("vae_path"):
        return load_vae_checkpoint(field("vae_path"))
    if field("taming"):
        if not (field("vqgan_model_path") and field("vqgan_config_path")):
            raise ValueError("the VQGAN (--taming) needs vqgan_model_path and vqgan_config_path")
        return vae_io.VQGanVAE(field("vqgan_model_path"), field("vqgan_config_path"))
    return vae_io.OpenAIDiscreteVAE()


def load_dalle_checkpoint(path: str, opt: bool = True):
    """Returns (config dict, dalle tree, vae tree or None, metadata,
    optimizer leaves or None); `restore_opt_state` takes the leaves.
    `opt=False` leaves the optimizer state unread (None)."""
    params, meta = load_params_npz(path, skip=() if opt else ("opt",))
    if meta.get("type") != "DALLE":
        raise ValueError(f"{path} is not a DALLE checkpoint")
    leaves = opt_leaves(params["opt"]) if "opt" in params else None
    return meta["config"], params["dalle"], params.get("vae"), meta, leaves


def restore_opt_state(model: DALLE, optimizer, leaves, layout: str = "unrolled") -> bool:
    """Load saved optimizer leaves (their moments in `layout`) into
    `optimizer` (over `model`'s parameters). On a mismatch of count or
    shapes (the optimizer config changed) the optimizer stays fresh, with a
    warning, as the reference's `restore_opt_state` leaves it. Returns
    whether the state was loaded."""
    if leaves is None:
        return False
    shapes = dalle_opt_shapes(model, layout)
    if len(shapes) != len(leaves) or any(
        shape != np.shape(leaf) for shape, leaf in zip(shapes, leaves)
    ):
        print(
            "WARNING: checkpoint optimizer state does not match the current "
            "optimizer (config changed?) — starting with a fresh optimizer"
        )
        return False
    load_dalle_opt_state(model, optimizer, leaves, layout)
    return True


def clip_hparams(clip: CLIP) -> dict:
    """The checkpoint `clip_hparams` dict of a port CLIP (the reference's
    keys; `executor` is the layout of its checkpoints)."""
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
        "executor": clip.executor,
    }


def save_clip_checkpoint(path: str, clip: CLIP) -> None:
    """The reference's single-file CLIP checkpoint: the CLIP tree, in the
    layout `clip.executor` names, and the `clip_hparams` metadata."""
    save_params_npz(path, export_clip_params(clip, clip.executor),
                    metadata={"clip_hparams": clip_hparams(clip)})


def load_clip_checkpoint(path: str) -> CLIP:
    """A float32 CLIP with the checkpoint's weights (either layout), on
    the CPU."""
    params, metadata = load_params_npz(path)
    return load_clip_params(CLIP(**metadata["clip_hparams"]), params)
