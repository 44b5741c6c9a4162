"""Train DALL-E on the card (the port's twin of the repository's
`train_dalle.py`).

    python -m dalle_pytorch_tpu_torch.train_dalle --image_text_folder rainbow:64 \\
        --vae_path vae.npz [--exp r] [--epochs 2] [--batch_size 4] \\
        [--set model.depth=2] [--set save_every_n_steps=100] \\
        [--dalle_path dalle.npz] [--resume] [--tokens_path tokens.npz] [--device cpu]

The flags are the reference CLI's, plus `--device` (the card unless
`--device cpu`); `--set key=value` overrides any `training/config.py`
field, and `--config` reads a YAML file (which needs PyYAML). Several
GPUs train through the launcher, one process a GPU:

    python -m dalle_pytorch_tpu_torch.launch [--nproc_per_host 2] -- \
        -m dalle_pytorch_tpu_torch.train_dalle ... --set mesh.fsdp=2

The flow:

* `--dalle_path` resumes weights, the Adam state, the config, the epoch,
  the global step and the plateau scheduler from a single-file export
  (`--set` overrides apply on top of its config);
* up front, before any model is built, it refuses what the port does not
  run: `ga_steps` not dividing `batch_size`, fsdp or tp with the revnet
  executor (ROADMAP Queue 1 item 8), the JAX trainer's checks of
  `mesh.pp` above 1 (`check_pipeline`), `--taming` without both VQGAN
  paths, and, with `model.executor="scan"`, a model the JAX scan executor
  does not run (its reason);
* the process joins the launcher's process group
  (`parallel/mesh.py:initialize_distributed`; nothing at one process, on
  `cuda:{LOCAL_RANK % device_count}`, Gloo or NCCL by `process_backend`;
  a group the caller joined already is used and left open at the end)
  and builds the training mesh from `mesh.dp` / `fsdp` / `tp` / `sp` (dp
  = -1 takes the ranks left) / `pp` (pure-pp: every other axis 1,
  `check_pipeline`); `batch_size` is a data rank's rows
  (the global batch is `batch_size` x dp x fsdp: the JAX trainer's
  per-process batch), each data rank reads its shard of the dataset, the
  tp, sp and pp ranks of a data coordinate the same rows;
  `model.attn_impl="ring"` runs attention as ring attention over the sp
  ranks; the model and its Adam state are cut into tp shards (heads,
  FF hidden units and vocabulary, `parallel/tensor_parallel.py`) and
  split over fsdp (`parallel/fsdp.py`) after any resume has loaded them
  whole; under pp the trunk runs as a GPipe schedule over the stages in
  `mesh.pp_micro` microbatches (`models/transformer.py:
  make_pipeline_trunk`);
* the VAE is the trained dVAE at `--vae_path`, else the VQGAN
  (`--taming`), else the OpenAI dVAE from its cache directory
  (`build_vae`); the pretrained wrappers encode in the step as the dVAE
  does, and the exports then carry no VAE weights, as the reference's;
* `model.reversible_impl="revnet"` trains the two-stream RevNet
  (`models/transformer.py`); `model.executor="scan"` trains the same
  unrolled modules and writes every export and step checkpoint (weights
  and Adam moments) in the JAX scan executor's layout, which
  `--dalle_path` and `--resume` read back;
* batches come from the dataset `build_dataset` names (rainbow, a folder,
  tar shards) through a `Prefetcher` thread that lays them out in pinned
  host memory; the main thread copies them to the card and the step
  encodes the images with the frozen dVAE (the in-step encode), or, with
  `--tokens_path` (a `precompute_tokens` artifact), trains from its
  tokens;
* every optimizer step draws from its own key, `step_key(seed,
  global_step)`: the null-conditioning generator and the dropout masks
  (torch's global generators are seeded from it, a data rank other than
  the first from its own seed, `dropout_seed`), so a resumed run draws
  what an uninterrupted one draws; `steps_per_dispatch` groups
  the steps into windows of that many (`make_multi_step`), each step with
  its own key and its own batch, whose cadences are checked once, after
  the window's last step, on the window's mean metrics (an epoch tail
  shorter than a window checks them after each of its steps);
* the loss is read back (a host sync) only when the step crosses a
  multiple of 10, and printed then; step checkpoints go to
  `<output_dir>/dalle_ckpt/` at `save_every_n_steps` (`CheckpointManager`,
  `keep_n_checkpoints` kept), and `--resume` restores the latest, skips
  the batches its epoch already took and carries that epoch's losses, so
  the run continues as if it had not stopped;
* at `log_images_freq` one image is sampled from the batch's first
  caption (`generate_images_cached` over the float32 parameters, outside
  autocast, where the reference samples in its compute dtype) and
  decoded by the dVAE into `<output_dir>/logs/` (or wandb); every rank
  samples, over the gathered parameters, and only rank 0 logs;
* exports and step checkpoints gather the full parameters and Adam
  moments on every rank (a collective) and rank 0 writes them: one npz of
  full tensors whatever the mesh, so a run saved at one world size
  resumes at another;
* `sample_per_sec` (this process's rows), `input_wait_frac` and `mfu`
  (None away from an H100; the rate over the tp, sp and pp ranks sharing
  the rows)
  are logged by rank 0 every 10 steps; each step's time (a CUDA event
  pair around it on the card) and its loss (read once at the end) are in
  the summary `main` returns; the plateau scheduler steps once an epoch
  (`lr_decay`), and `<output_dir>/<dalle_output_file_name>.npz` is
  written at the start, after every epoch and at the end (unless the last
  epoch's export is that file already), with the Adam state and the
  global step.

`main(argv)` runs in-process and returns a summary of the run.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dalle_pytorch_tpu_torch.data.loader import TokenDataset
from dalle_pytorch_tpu_torch.data.prefetch import Prefetcher, host_tensors, to_device
from dalle_pytorch_tpu_torch.models.dalle import generate_images_cached
from dalle_pytorch_tpu_torch.models.dvae import DiscreteVAE, exact_float32
from dalle_pytorch_tpu_torch.models.vae_io import decode_unit
from dalle_pytorch_tpu_torch.ops.sampling import row_seed
from dalle_pytorch_tpu_torch.parallel.fsdp import gathered
from dalle_pytorch_tpu_torch.parallel.mesh import (
    host_barrier,
    initialize_distributed,
    is_root,
    make_train_mesh,
    rank_device,
)
from dalle_pytorch_tpu_torch.serving.engine import resolve_device
from dalle_pytorch_tpu_torch.training.checkpoint import CheckpointManager
from dalle_pytorch_tpu_torch.training.config import (
    TrainConfig,
    _merge_dict,
    _set_dotted,
    config_to_dict,
    load_config,
)
from dalle_pytorch_tpu_torch.training.lr import ReduceLROnPlateau
from dalle_pytorch_tpu_torch.training.metrics import (
    MetricsLogger,
    ProfilerHook,
    StepTimer,
    ThroughputMeter,
)
from dalle_pytorch_tpu_torch.training.pipeline import (
    build_dataset,
    build_tokenizer,
    build_vae,
    checkpoint_layout,
    dalle_from_config,
    dvae_hparams,
    load_dalle_checkpoint,
    opt_leaves,
    opt_tree,
    restore_opt_state,
    save_dalle_checkpoint,
)
from dalle_pytorch_tpu_torch.training.steps import (
    MODES,
    get_learning_rate,
    make_dalle_train_step,
    make_multi_step,
    make_optimizer,
    set_learning_rate,
    step_key,
    window_iter,
    window_keys,
)
from dalle_pytorch_tpu_torch.utils.flops import dalle_train_flops_per_sample, mfu
from dalle_pytorch_tpu_torch.weights import (
    dalle_tree_layout,
    export_dalle_opt_state,
    export_dalle_params,
    export_dvae_params,
    load_dalle_opt_state,
    load_dalle_params,
    load_dvae_params,
)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--image_text_folder", type=str, default=None)
    p.add_argument("--tokens_path", type=str, default=None,
                   help="precompute_tokens artifact; trains from tokens")
    p.add_argument("--vae_path", type=str, default=None)
    p.add_argument("--dalle_path", type=str, default=None, help="resume checkpoint")
    p.add_argument(
        "--resume", action="store_true",
        help="resume the full train state from the latest step checkpoint in output_dir",
    )
    p.add_argument("--taming", action="store_true")
    p.add_argument("--exp", type=str, default=None, choices=["f", "ff", "r", "ro"])
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--debug", action="store_true")
    p.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="config override, e.g. --set model.depth=4",
    )
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def check_config(cfg: TrainConfig) -> None:
    """Refuse, before any model is built, what the port does not run."""
    if cfg.ga_steps < 1 or cfg.batch_size % cfg.ga_steps:
        raise ValueError(
            f"ga_steps={cfg.ga_steps} must divide batch_size={cfg.batch_size}: "
            "each gradient-accumulation step takes batch_size // ga_steps rows"
        )
    m = cfg.mesh
    if m.pp > 1:
        check_pipeline(cfg)
    for axis in ("fsdp", "tp"):
        if getattr(m, axis) > 1 and cfg.model.reversible and cfg.model.reversible_impl != "remat":
            raise NotImplementedError(
                f"mesh.{axis} > 1 with the revnet executor, whose backward takes the parameters "
                "themselves, is not ported; ROADMAP Queue 1 item 8"
            )
    if cfg.mode not in MODES:
        raise ValueError(f"unknown mode {cfg.mode!r}; one of {MODES}")
    m = cfg.model
    if m.reversible and m.reversible_impl != "remat" and (m.attn_dropout or m.ff_dropout):
        raise ValueError(
            "the revnet executor requires deterministic execution (no dropout); "
            "use reversible_impl='remat' for dropout training"
        )
    if not cfg.vae_path and cfg.taming and not (cfg.vqgan_model_path and cfg.vqgan_config_path):
        raise ValueError("--taming needs vqgan_model_path and vqgan_config_path (--set ...)")
    checkpoint_layout(config_to_dict(cfg))


def check_pipeline(cfg: TrainConfig) -> None:
    """The JAX trainer's checks of mesh.pp > 1, in its words: the scan
    executor, no dropout, no forward_reverse_partial, a depth the stages
    divide, `pp_micro` dividing a gradient-accumulation step's rows, and a
    pure-pp mesh."""
    pp = cfg.mesh.pp
    if cfg.model.executor != "scan":
        raise ValueError(
            "mesh.pp > 1 requires model.executor=scan (the pipeline runs the depth-stacked "
            "scan layout)"
        )
    if cfg.model.attn_dropout or cfg.model.ff_dropout:
        raise ValueError(
            "mesh.pp > 1 requires attn_dropout=ff_dropout=0: the pp trunk is deterministic by "
            "design (models/dalle.py); use dp/fsdp/tp for dropout training"
        )
    if cfg.mode == "forward_reverse_partial":
        raise ValueError(
            "mesh.pp > 1 cannot run forward_reverse_partial (the pipeline owns the layer order; "
            "reversed-order execution is a sequential-trunk feature)"
        )
    if cfg.model.depth % pp:
        raise ValueError(f"model.depth={cfg.model.depth} not divisible by mesh.pp={pp}")
    micro = max(1, int(cfg.mesh.pp_micro))
    if (cfg.batch_size // max(1, cfg.ga_steps)) % micro:
        raise ValueError(
            f"mesh.pp_micro={micro} must divide the per-accum-step batch "
            f"({cfg.batch_size}//{cfg.ga_steps}); lower pp_micro or raise batch_size"
        )
    m = cfg.mesh
    if m.fsdp != 1 or m.tp != 1 or m.sp != 1 or m.dp not in (1, -1):
        raise ValueError(
            "mesh.pp > 1 is a pure-pp mesh: set dp/fsdp/tp/sp to 1 (pp composed with the other "
            "axes is not ported; ROADMAP Queue 1 item 8)"
        )


def _config(args) -> tuple:
    """(cfg, the resume checkpoint's contents or None)."""
    cfg = load_config(args.config, args.set)
    resume = None
    if args.dalle_path:
        config, dalle_tree, vae_tree, meta, leaves = load_dalle_checkpoint(args.dalle_path)
        cfg = TrainConfig()
        _merge_dict(cfg, config)
        for ov in args.set:
            k, v = ov.split("=", 1)
            _set_dotted(cfg, k.strip(), v.strip())
        resume = dict(dalle=dalle_tree, vae=vae_tree, meta=meta, opt=leaves)
    for k in ("epochs", "batch_size", "learning_rate", "image_text_folder",
              "tokens_path", "vae_path", "exp"):
        v = getattr(args, k)
        if v is not None:
            setattr(cfg, k, v)
    if args.taming:
        cfg.taming = True
    if args.debug:
        cfg.debug = True
    return cfg.resolve(), resume


def dropout_seed(key: int, data_rank: int) -> int:
    """The seed of a step's dropout masks on data rank `data_rank`: the
    one-device run's (`row_seed(key, 1)`) on the first, its own on each
    other (the sp ranks of a data coordinate share it)."""
    seed = row_seed(key, 1)
    return seed if data_rank == 0 else row_seed(seed, data_rank)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg, resume = _config(args)
    check_config(cfg)
    device = rank_device(device)
    joined = dist.is_initialized()  # the caller's group: the caller closes it
    backend = initialize_distributed(device=device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    m = cfg.mesh
    mesh = make_train_mesh(dp=m.dp, fsdp=m.fsdp, tp=m.tp, sp=m.sp, pp=m.pp, device=device)
    if mesh.world > 1:
        print(f"rank {mesh.rank} of {mesh.world}: mesh {mesh.shape}, coordinates {mesh.coords}, "
              f"device {device}, backend {backend}")

    layout = checkpoint_layout(config_to_dict(cfg))
    tokenizer = build_tokenizer(config_to_dict(cfg))
    vae = build_vae(cfg)
    trained_vae = isinstance(vae, DiscreteVAE)
    if resume is not None and resume["vae"] is not None and trained_vae:
        load_dvae_params(vae, resume["vae"])
    image_fmap_size = vae.fmap_size
    if cfg.tokens_path:
        # offline-precomputed tokens: the step skips the VAE encode
        dataset = TokenDataset(cfg.tokens_path, tokenizer, cfg.model.text_seq_len)
        if dataset.num_tokens != vae.num_tokens:
            raise ValueError(
                f"tokens were precomputed with a {dataset.num_tokens}-code VAE "
                f"but --vae_path has {vae.num_tokens}"
            )
        if dataset.image_tokens.shape[1] != image_fmap_size**2:
            raise ValueError(
                f"tokens artifact has {dataset.image_tokens.shape[1]} tokens per "
                f"image (VAE {dataset.image_size}px/{dataset.num_layers} layers) "
                f"but the model expects {image_fmap_size}^2 = {image_fmap_size**2} "
                "— wrong --tokens_path for this VAE?"
            )
    else:
        dataset = build_dataset(cfg, tokenizer, image_size=vae.image_size)
    try:
        print(f"{len(dataset)} image-text pairs for training")
    except TypeError:  # streaming tar shards have no cheap length
        print("streaming dataset for training (length unknown)")

    torch.manual_seed(cfg.seed)
    with device:  # initialized where it trains
        model, _ = dalle_from_config(
            config_to_dict(cfg), num_image_tokens=vae.num_tokens,
            image_fmap_size=image_fmap_size, vocab_size=max(tokenizer.vocab_size, 1),
            sp_mesh=mesh,
        )
    if resume is not None:
        load_dalle_params(model, resume["dalle"])
    print(f"{sum(p.numel() for p in model.parameters()):,} parameters")
    vae.to(device)

    opt = make_optimizer(model.parameters(), cfg.learning_rate, clip_grad_norm=cfg.clip_grad_norm)
    resume_meta = resume["meta"] if resume is not None else {}
    resume_train = resume_meta.get("train", {})
    if resume is not None:
        restore_opt_state(model, opt, resume["opt"], dalle_tree_layout(resume["dalle"]))

    in_step_encode = not cfg.tokens_path
    run_dir = Path(cfg.output_dir)
    ckpt = CheckpointManager(run_dir / "dalle_ckpt", keep_n=cfg.keep_n_checkpoints)
    step_meta = None
    summary = dict(resumed_step=None, losses=[], rates=[], save_s=[], export_s=[], sample_s=[], load_s=0.0,
                   mesh=dict(mesh.shape), rank=mesh.rank, backend=backend)
    if args.resume:
        t0 = time.perf_counter()
        restored, step_meta, rstep = ckpt.restore()
        if restored is not None:
            leaves = opt_leaves(restored["opt"])
            load_dalle_params(model, restored["dalle"])
            load_dalle_opt_state(model, opt, leaves, dalle_tree_layout(restored["dalle"]))
            summary.update(resumed_step=rstep, load_s=time.perf_counter() - t0,
                           resumed_adam_count=int(leaves[2]),
                           resumed_plateau=step_meta.get("plateau"))
            print(f"resumed full train state from step checkpoint {rstep}")
        else:
            print("no step checkpoint found in output_dir; starting fresh")

    # the whole model and Adam state are loaded: split them over the mesh
    raw_step = make_dalle_train_step(
        model, opt, mode=cfg.mode, grad_accum=cfg.ga_steps, null_cond_prob=cfg.null_cond_prob,
        autocast_dtype=torch.bfloat16 if cfg.bf16 else None,
        vae=vae if in_step_encode else None, mesh=mesh, pp_micro=max(1, int(m.pp_micro)),
    )

    on_card = device.type == "cuda"
    timer = StepTimer(on_card)

    def keyed_step(host_batch, key: int):
        """One step on a host batch, keyed and timed."""
        timer.start()
        torch.manual_seed(dropout_seed(key, mesh.data_rank))  # this step's dropout masks
        metrics = raw_step(to_device(host_batch, device),
                           torch.Generator().manual_seed(row_seed(key, 0)))
        timer.stop()
        return metrics

    steps_per_dispatch = max(1, int(cfg.steps_per_dispatch))
    # a full window, and each step of an epoch tail shorter than one
    run_steps = {n: make_multi_step(keyed_step, n) for n in {1, steps_per_dispatch}}

    root = is_root()
    logger = MetricsLogger(
        project=cfg.wandb_name, config={"cli": "train_dalle"}, enabled=root, debug=cfg.debug,
        out_dir=str(run_dir / "logs"), entity=cfg.wandb_entity,
    )
    flops_per_sample = dalle_train_flops_per_sample(model, mode=cfg.mode)
    device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    meter = ThroughputMeter()
    profiler = ProfilerHook(cfg.flops_profiler, out_dir=str(run_dir / "profiles"))
    plateau = ReduceLROnPlateau() if cfg.lr_decay else None
    if plateau is not None and resume_train.get("plateau"):
        plateau.load_state_dict(resume_train["plateau"])
    # a trained dVAE travels in the export; a pretrained wrapper does not
    keep_vae = in_step_encode and trained_vae
    vae_tree = export_dvae_params(vae) if keep_vae else None

    exported = {}

    def export(path: Path, epoch: int):
        """The export: full tensors gathered on every rank, written by
        rank 0."""
        t0 = time.perf_counter()
        exported.update(epoch=epoch, step=global_step)
        with gathered(model, opt):
            if root:
                save_dalle_checkpoint(
                    str(path), config_to_dict(cfg), model, vae_tree, epoch, type(vae).__name__,
                    vae_hparams=dvae_hparams(vae) if keep_vae else None,
                    train_meta={"global_step": global_step,
                                "plateau": plateau.state_dict() if plateau else None},
                    opt_state=export_dalle_opt_state(model, opt, layout),
                )
        summary["export_s"].append(time.perf_counter() - t0)

    out_file = run_dir / f"{cfg.dalle_output_file_name}.npz"
    resume_epoch = resume_meta.get("epoch", 0)
    global_step = int(resume_train.get("global_step", 0))
    if step_meta:
        resume_epoch = int(step_meta.get("epoch", resume_epoch))
        global_step = int(step_meta.get("step", global_step))
        if plateau is not None and step_meta.get("plateau"):
            plateau.load_state_dict(step_meta["plateau"])
    export(out_file, resume_epoch)  # fail early, before any step
    stop = False
    # a mid-epoch resume skips the batches the checkpointed run took
    skip_batches = int((step_meta or {}).get("epoch_batch", 0))
    batch_iter, last_loss = None, None
    step_losses = []  # each step's (window's) loss, read once at the end
    for epoch in range(resume_epoch, cfg.epochs):
        if stop:
            break
        epoch_losses = []
        last_loss = None
        epoch_batch = 0

        def assemble(batch):
            """(host tensors of the step's batch, pinned on a card; its
            captions; its first text row)."""
            keys = ("text", "images") if in_step_encode else ("text", "image_tokens")
            host = host_tensors({k: batch[k] for k in keys}, on_card)
            return host, batch.get("captions"), np.asarray(batch["text"][:1])

        raw_batches = dataset.batches(
            cfg.batch_size, shuffle_seed=cfg.seed + epoch, shard=(mesh.data_rank, mesh.data_world),
            start_batch=skip_batches if epoch == resume_epoch else 0,
        )
        batch_iter = Prefetcher(window_iter(raw_batches, steps_per_dispatch),
                                transform=lambda win: [assemble(b) for b in win],
                                depth=cfg.prefetch_depth)
        if epoch == resume_epoch and skip_batches:
            epoch_batch = skip_batches
            # the interrupted epoch's losses, so its plateau step sees what
            # an uninterrupted run's does
            epoch_losses = list(step_meta.get("epoch_losses") or [])
            if step_meta.get("last_loss") is not None:
                last_loss = float(step_meta["last_loss"])
        try:
            for window in batch_iter:
                # a full window checks its cadences once; the steps of an
                # epoch tail shorter than a window, each
                for part in ([window] if len(window) == steps_per_dispatch
                             else [[one] for one in window]):
                    profiler.before_step(global_step)
                    prev_step = global_step
                    metrics = run_steps[len(part)](
                        [host for host, _, _ in part], window_keys(cfg.seed, global_step, len(part)))
                    _, captions, text_head = part[0]
                    global_step += len(part)
                    epoch_batch += len(part)

                    def crossed(interval):
                        # cadences fire on interval crossings, so a window of
                        # several steps cannot step over one
                        return bool(interval) and global_step // interval > prev_step // interval

                    last_loss = metrics["loss"]  # a device scalar: no sync here
                    step_losses.append(last_loss)
                    log = {}
                    if crossed(10):
                        step_loss = float(last_loss)
                        epoch_losses.append(step_loss)
                        summary["losses"].append((global_step, step_loss))
                        log.update(
                            epoch=epoch, iter=global_step, loss=step_loss,
                            forward_loss=float(metrics.get("forward_loss", 0.0)),
                            inverse_loss=float(metrics.get("inverse_loss", 0.0)),
                        )
                        if "accuracy" in metrics:
                            log["accuracy"] = float(metrics["accuracy"])
                        if root:
                            print(epoch, global_step, f"loss - {step_loss:.5f}")

                    if crossed(cfg.save_every_n_steps):
                        t0 = time.perf_counter()
                        with gathered(model, opt):  # every rank gathers, rank 0 writes
                            if root:
                                ckpt.save(
                                    global_step,
                                    {"dalle": export_dalle_params(model, layout),
                                     "opt": opt_tree(export_dalle_opt_state(model, opt, layout))},
                                    metadata={
                                        "epoch": epoch, "step": global_step,
                                        "epoch_batch": epoch_batch, "epoch_losses": epoch_losses,
                                        "last_loss": float(last_loss) if last_loss is not None else None,
                                        "plateau": plateau.state_dict() if plateau else None,
                                    },
                                )
                        summary["save_s"].append(time.perf_counter() - t0)

                    if crossed(cfg.log_images_freq):
                        # every rank samples (over the gathered parameters);
                        # the logger writes on rank 0 only
                        t0 = time.perf_counter()
                        sample_key = row_seed(step_key(cfg.seed, global_step), 2)
                        text = torch.as_tensor(text_head, device=device)
                        model.eval()
                        with gathered(model):
                            toks = generate_images_cached(model, text, sample_key, filter_thres=0.9)
                        model.train()
                        with torch.no_grad(), exact_float32():
                            image = decode_unit(vae, toks).cpu().numpy()
                        caption = (captions or [None])[0] or tokenizer.decode(text_head[0])
                        logger.log_images(image, caption, "image", global_step)
                        summary["sample_tokens"] = toks.cpu().numpy()
                        summary["sample_s"].append(time.perf_counter() - t0)

                    rate = meter.update(global_step, cfg.batch_size)
                    if rate is not None:
                        log["sample_per_sec"] = rate  # this process's rows
                        log["input_wait_frac"] = round(batch_iter.wait_fraction, 4)
                        # the tp, sp and pp ranks of a data coordinate share its rows
                        sharing = mesh.shape["tp"] * mesh.shape["sp"] * mesh.shape["pp"]
                        util = mfu(rate, flops_per_sample, device_name, sharing)
                        log["mfu"] = None if util is None else round(util, 4)
                        summary["rates"].append({k: log[k] for k in ("sample_per_sec", "input_wait_frac", "mfu")})
                        if root:
                            print(epoch, global_step, f"sample_per_sec - {rate:.2f}")
                    if log:
                        logger.log(log, step=global_step)
                    if profiler.after_step(global_step):
                        print("Profiler has finished running. Stopping training early.")
                        stop = True
                        break
                if stop:
                    break
        finally:
            batch_iter.close()

        if plateau is not None and last_loss is not None:
            # the epoch's sampled losses and its last step's, averaged
            epoch_losses.append(float(last_loss))
            set_learning_rate(opt, plateau.step(float(np.mean(epoch_losses)), get_learning_rate(opt)))
        # epoch + 1: this epoch is done; a --dalle_path resume starts the next
        export(out_file, epoch + 1)
        logger.log_model_artifact(out_file)

    if exported != {"epoch": cfg.epochs, "step": global_step}:  # else written already
        export(out_file, cfg.epochs)
    ckpt.wait()
    if on_card:
        torch.cuda.synchronize()  # the steps' end events
    logger.finish()
    if root:
        print(f"final checkpoint -> {out_file}")
    summary["step_losses"] = [float(x) for x in step_losses]
    summary["staged_calls"] = dict(mesh.comm.staged)
    summary["collective_calls"] = dict(mesh.comm.calls)
    summary["collective_bytes"] = dict(mesh.comm.bytes)
    if backend is not None:
        host_barrier()
        if not joined:
            dist.destroy_process_group()
    summary.update(
        global_step=global_step, out_file=str(out_file),
        last_loss=None if last_loss is None else float(last_loss),
        input_wait_frac=batch_iter.wait_fraction if batch_iter is not None else None,
        learning_rate=get_learning_rate(opt),
        step_ms=timer.step_ms(),
        flops_per_sample=flops_per_sample, device_name=device_name,
        plateau=plateau.state_dict() if plateau else None,
    )
    return summary


if __name__ == "__main__":
    main()
