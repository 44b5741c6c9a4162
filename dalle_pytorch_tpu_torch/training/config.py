"""The trainer's configuration: one dataclass tree with presets.

Counterpart of the JAX package's `training/config.py`, copied (it is host
code): `TrainConfig` with its `model` (`DalleConfig`), `vae`
(`VaeConfig`) and `mesh` (`MeshConfig`) sections, the objective presets
`EXP_PRESETS` (f / ff / r / ro), dotted `key=value` overrides
(`_set_dotted`), YAML merging (`_merge_dict`, `load_config`) and
`config_to_dict`, which gives the dict a checkpoint's metadata stores:
the same dict as the JAX package's for the same YAML and overrides, so a
checkpoint's config loads in both packages.

`import yaml` stays inside `load_config`: a YAML file needs PyYAML, and a
machine without it raises there, naming the package; `--set` overrides
need nothing. `mesh` sizes the trainer's process grid (one process a
GPU): dp, fsdp and sp train (`parallel/fsdp.py`, `parallel/ring.py`);
the trainer refuses tp and pp above 1 (ROADMAP Queue 1 item 8). A bad
`exp` preset or an override without "=" raises ValueError (the
reference asserts).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, List, Optional, Sequence, Tuple

# exp presets (`config/exp/{f,ff,r,ro}.yaml`)
EXP_PRESETS = {
    "f": "forward_only",
    "ff": "forward_forward",
    "r": "forward_reverse_partial",
    "ro": "reverse_only",
}


@dataclass
class MeshConfig:
    dp: int = -1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    # pipeline parallelism (the JAX parallel/gpipe.py GPipe schedule over
    # the transformer trunk; not ported: the port's trainer refuses
    # pp > 1). There pp > 1 requires executor="scan", zero dropout
    # (the pp trunk is deterministic by design — models/dalle.py), a mode
    # without reversed layer order, and dp/fsdp/tp/sp all 1 (pure-pp
    # mesh; compose dp x pp via parallel/gpipe.pipeline_layers directly)
    pp: int = 1
    pp_micro: int = 4  # GPipe microbatches per step (batch % pp_micro == 0)


@dataclass
class VaeConfig:
    image_size: int = 128
    num_tokens: int = 8192
    codebook_dim: int = 512
    num_layers: int = 3
    num_resnet_blocks: int = 0
    hidden_dim: int = 64
    channels: int = 3
    smooth_l1_loss: bool = False
    temperature: float = 0.9
    straight_through: bool = False
    reinmax: bool = False
    kl_loss_weight: float = 0.0
    # gumbel temperature annealing (`train_vae.py:278`)
    anneal_rate: float = 1e-6
    temp_min: float = 0.5


@dataclass
class DalleConfig:
    dim: int = 512
    text_seq_len: int = 256
    depth: int = 2
    heads: int = 8
    dim_head: int = 64
    ff_dropout: float = 0.0
    attn_dropout: float = 0.0
    reversible: bool = False
    reversible_impl: str = "remat"  # remat | revnet
    # jax.checkpoint policy for the remat executor (e.g.
    # "dots_with_no_batch_dims_saveable"); None = full recompute
    remat_policy: "Optional[str]" = None
    loss_img_weight: float = 7.0
    attn_types: str = "full"  # comma separated
    shift_tokens: bool = False
    rotary_emb: bool = False
    shared_attn_ids: Optional[str] = None  # comma separated
    shared_ff_ids: Optional[str] = None
    share_input_output_emb: bool = False
    stable_softmax: bool = False
    sandwich_norm: bool = False
    num_text_tokens: int = 10000  # overridden by tokenizer vocab size
    # vocab-chunked cross-entropy (ops/losses.py): forward objective
    # without materializing [B, N, vocab] logits
    fused_ce: bool = False
    # attention kernel selection: "dense" | "flash" (in-repo Pallas) |
    # "lib_flash" (jax library TPU kernel, plain causal/full only) |
    # "ring" (sequence-parallel over the mesh sp axis) | "auto" (dense
    # below AUTO_FLASH_MIN_SEQ, flash above; ring when mesh.sp > 1)
    attn_impl: str = "auto"
    # layer executor: "unrolled" | "scan" (nn.scan over depth-stacked
    # params — ~depth× smaller program/compile; masked attn_types run as
    # dense + scanned pattern masks, no shared ids; cached decode is
    # native, pattern masks included)
    executor: str = "unrolled"

    def attn_types_tuple(self) -> Tuple[str, ...]:
        return tuple(s.strip() for s in self.attn_types.split(",") if s.strip())

    @staticmethod
    def _ids(spec: Optional[str]) -> Optional[Tuple[int, ...]]:
        if not spec:
            return None
        return tuple(int(s) for s in str(spec).split(","))

    def shared_attn_ids_tuple(self):
        return self._ids(self.shared_attn_ids)

    def shared_ff_ids_tuple(self):
        return self._ids(self.shared_ff_ids)


@dataclass
class TrainConfig:
    # run / logging (`config/config.yaml`)
    debug: bool = False
    project: str = "dalle_pytorch_tpu"
    mode: str = "forward_only"
    exp: Optional[str] = None  # preset key overriding mode
    wandb_name: str = "dalle_train_transformer"
    wandb_entity: Optional[str] = None
    # accepted for reference-CLI parity (`config/config.yaml`); the
    # trainer, like the reference's, generates one sample per log step
    wandb_num_images: int = 4
    log_images_freq: int = 1000

    # paths
    vae_path: Optional[str] = None
    dalle_path: Optional[str] = None
    vqgan_model_path: Optional[str] = None
    vqgan_config_path: Optional[str] = None
    image_text_folder: Optional[str] = None
    tokens_path: Optional[str] = None  # precompute_tokens.py artifact
    wds: str = ""
    output_dir: str = "checkpoints"
    dalle_output_file_name: str = "dalle"

    # tokenizer flags (`train_dalle.py:131-135`)
    chinese: bool = False
    taming: bool = False
    hug: bool = False
    yttm: bool = False
    native: bool = False  # framework-native C++ BPE (native/bpe.cpp)
    bpe_path: Optional[str] = None
    truncate_captions: bool = False

    # data
    resize_ratio: float = 0.75
    class_name_json: Optional[str] = None

    # optimization
    epochs: int = 20
    save_every_n_steps: int = 1000
    keep_n_checkpoints: Optional[int] = None
    batch_size: int = 4
    ga_steps: int = 1
    # optimizer steps scanned into ONE device dispatch (make_multi_step):
    # eliminates the host-loop round trip per step — the dominant cost on
    # synchronous-dispatch backends. Logging/checkpoint cadences fire on
    # interval crossings, so their effective granularity becomes this many
    # steps. 1 = classic per-step host loop.
    steps_per_dispatch: int = 1
    # batches assembled ahead of the step by the prefetch thread
    # (DataLoader-workers equivalent, `train_dalle.py:309-316`); 0 would
    # mean no lookahead but still off-thread assembly
    prefetch_depth: int = 2
    learning_rate: float = 3e-4
    clip_grad_norm: float = 0.5
    lr_decay: bool = False
    null_cond_prob: float = 0.0
    seed: int = 42

    # precision / profiling
    bf16: bool = True  # replaces --fp16/--amp (`train_dalle.py:326,385-388`)
    flops_profiler: bool = False

    # inverse-objective coefficients (`config/config.yaml:21-24`)
    text_loss_coeff: float = 1.0
    text_loss_coeff_inv: float = 7.0
    img_loss_coeff: float = 7.0
    img_loss_coeff_inv: float = 1.0

    model: DalleConfig = field(default_factory=DalleConfig)
    vae: VaeConfig = field(default_factory=VaeConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def resolve(self) -> "TrainConfig":
        if self.exp:
            if self.exp not in EXP_PRESETS:
                raise ValueError(f"unknown exp preset {self.exp}")
            self.mode = EXP_PRESETS[self.exp]
        return self


def _set_dotted(obj: Any, key: str, value: Any) -> None:
    parts = key.split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    leaf = parts[-1]
    if not hasattr(obj, leaf):
        raise KeyError(f"unknown config key: {key}")
    current = getattr(obj, leaf)
    if isinstance(current, bool):
        value = str(value).lower() in ("1", "true", "yes", "on")
    elif isinstance(current, int) and not isinstance(current, bool):
        value = int(value)
    elif isinstance(current, float):
        value = float(value)
    elif value in ("null", "None", ""):
        value = None
    elif current is None and isinstance(value, str):
        # Optional[int/float] fields (e.g. keep_n_checkpoints): infer type
        for cast in (int, float):
            try:
                value = cast(value)
                break
            except ValueError:
                continue
    setattr(obj, leaf, value)


def _merge_dict(cfg: Any, data: dict, prefix: str = "") -> None:
    for k, v in data.items():
        if isinstance(v, dict) and dataclasses.is_dataclass(getattr(cfg, k, None)):
            _merge_dict(getattr(cfg, k), v)
        else:
            _set_dotted(cfg, k, v) if not isinstance(v, (dict, list)) else setattr(cfg, k, v)


def load_config(
    yaml_path: Optional[str] = None, overrides: Sequence[str] = ()
) -> TrainConfig:
    """YAML file (optional) + `key=value` / `section.key=value` overrides."""
    cfg = TrainConfig()
    if yaml_path:
        try:
            import yaml
        except ImportError as exc:
            raise ImportError(
                f"--config {yaml_path}: reading a YAML config needs PyYAML, which "
                "is not installed here; pass the settings as --set key=value"
            ) from exc

        with open(yaml_path) as f:
            data = yaml.safe_load(f) or {}
        _merge_dict(cfg, data)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, value = ov.split("=", 1)
        _set_dotted(cfg, key.strip(), value.strip())
    return cfg.resolve()


def config_to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)
