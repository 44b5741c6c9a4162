"""Train the DiscreteVAE on the card (the port's twin of the repository's
`train_vae.py`).

    python -m dalle_pytorch_tpu_torch.train_vae --image_folder rainbow:64 \\
        [--config cfg.yaml] [--set vae.num_tokens=1024] [--set learning_rate=1e-3] \\
        [--epochs 2] [--batch_size 8] [--output vae.npz] [--lr_decay_rate 0.98] [--device cpu]

The flags are the reference CLI's, plus `--device` (the card unless
`--device cpu`); `--set key=value` overrides any `training/config.py`
field (the `vae.*` section is the model), `--config` reads a YAML file
(which needs PyYAML). The flow, as the reference's:

* batches of images from the dataset `build_dataset` names (rainbow, a
  folder, tar shards; `--image_folder`) come through a `Prefetcher`
  thread in windows of `steps_per_dispatch` (`make_multi_step`: a window
  runs its steps in turn; an epoch tail shorter than a window runs them
  one at a time, and its cadences are checked once after them);
* each step is `make_vae_train_step`: the Gumbel-softmax forward at the
  current temperature, the loss, Adam (no clipping, as the reference's);
  its Gumbel noise is drawn from the step's own key, `step_key(seed,
  global_step)` (torch's generator, not jax.random's bits);
* the loss is read back (a host sync) only when a step crosses a multiple
  of 10; at each crossed multiple of 100 the run logs the recon grid
  (orig | soft | hard: the Gumbel sample at the current temperature, and
  the argmax codes decoded) and the codebook-usage fraction, then, for
  every 100-step boundary the window crossed, at that boundary's own
  step value, anneals the temperature (temp * exp(-anneal_rate *
  boundary), floored at temp_min) and, with `lr_decay`, takes one
  `ExponentialDecay(--lr_decay_rate)` step of the learning rate;
* `--output` is written after every epoch and at the end
  (`save_vae_checkpoint`: the JAX `load_vae_checkpoint` reads it).

Several GPUs train through the launcher, one process a GPU, over the
data axes of the JAX trainer's mesh (`mesh.dp`, `mesh.fsdp`; dp = -1
takes the ranks left):

    python -m dalle_pytorch_tpu_torch.launch --nproc_per_host 2 -- \
        -m dalle_pytorch_tpu_torch.train_vae ... --set mesh.fsdp=2

`batch_size` is then a data rank's rows and each rank reads its block of
the dataset (the JAX trainer's `shard=(process_index, process_count)`);
the Gumbel noise is the step key's draw for the global batch, sliced by
rank; under fsdp each conv's output channels and the codebook's channels
are split (`parallel/partition.py:vae_fsdp_dims`, the JAX rank-4 conv
rule), with their Adam moments; gradients and the loss are averaged over
the data ranks (`parallel/fsdp.py`). The recon grid and the checkpoints
read the gathered parameters (a collective every rank runs) and rank 0
writes them. The JAX dVAE runs `mesh.tp` and `mesh.sp` above 1 as
replicated compute, no rule splitting anything over them: the port
refuses them (and `mesh.pp`), since replicas would only repeat the work.

`main(argv)` runs in-process and returns a summary of the run.
"""

from __future__ import annotations

import argparse
import math
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dalle_pytorch_tpu_torch.data.prefetch import Prefetcher, host_tensors, to_device
from dalle_pytorch_tpu_torch.parallel.fsdp import gathered
from dalle_pytorch_tpu_torch.parallel.mesh import (
    host_barrier,
    initialize_distributed,
    is_root,
    make_train_mesh,
    rank_device,
)
from dalle_pytorch_tpu_torch.serving.engine import resolve_device
from dalle_pytorch_tpu_torch.training.config import config_to_dict, load_config
from dalle_pytorch_tpu_torch.training.lr import ExponentialDecay
from dalle_pytorch_tpu_torch.training.metrics import MetricsLogger, StepTimer, ThroughputMeter
from dalle_pytorch_tpu_torch.training.pipeline import (
    build_dataset,
    build_tokenizer,
    save_vae_checkpoint,
    vae_from_config,
)
from dalle_pytorch_tpu_torch.training.steps import (
    get_learning_rate,
    make_multi_step,
    make_optimizer,
    make_vae_train_step,
    set_learning_rate,
    step_key,
    window_iter,
    window_keys,
)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", type=str, default=None, help="YAML config file")
    p.add_argument("--image_folder", type=str, default=None)
    p.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="config override, e.g. --set vae.num_tokens=1024",
    )
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--output", type=str, default="vae.npz")
    p.add_argument("--lr_decay_rate", type=float, default=0.98)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def check_mesh(cfg) -> None:
    """The dVAE trains over the data axes only: refuse tp, sp and pp above
    1 (replicated compute in the JAX dVAE)."""
    m = cfg.mesh
    for axis in ("tp", "sp", "pp"):
        if getattr(m, axis) > 1:
            raise ValueError(
                f"mesh.{axis}={getattr(m, axis)}: the dVAE has no {axis} split (the JAX rules name "
                "none; it would only replicate the work); train it over mesh.dp / mesh.fsdp"
            )


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.config, args.set)
    for k in ("epochs", "batch_size", "learning_rate"):
        v = getattr(args, k)
        if v is not None:
            setattr(cfg, k, v)
    if args.image_folder:
        cfg.image_text_folder = args.image_folder
    if args.debug:
        cfg.debug = True
    check_mesh(cfg)
    device = rank_device(device)
    joined = dist.is_initialized()  # the caller's group: the caller closes it
    backend = initialize_distributed(device=device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh = make_train_mesh(dp=cfg.mesh.dp, fsdp=cfg.mesh.fsdp, device=device)
    root = is_root()

    tokenizer = build_tokenizer(config_to_dict(cfg))
    dataset = build_dataset(cfg, tokenizer, image_size=cfg.vae.image_size)
    print(f"{len(dataset)} images for training")

    torch.manual_seed(cfg.seed)
    with device:  # initialized where it trains
        vae = vae_from_config(cfg.vae)
    opt = make_optimizer(vae.parameters(), cfg.learning_rate)
    raw_step = make_vae_train_step(vae, opt, grad_accum=cfg.ga_steps, mesh=mesh)
    on_card = device.type == "cuda"
    timer = StepTimer(on_card)
    temp = cfg.vae.temperature

    def generator(key: int) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(key)

    def keyed_step(host_batch, key: int):
        timer.start()
        metrics = raw_step(to_device(host_batch, device), temp, generator(key))
        timer.stop()
        return metrics

    steps_per_dispatch = max(1, int(cfg.steps_per_dispatch))
    run_steps = {n: make_multi_step(keyed_step, n) for n in {1, steps_per_dispatch}}

    logger = MetricsLogger(
        project=cfg.project, config={"cli": "train_vae"}, enabled=root, debug=cfg.debug,
        out_dir=str(Path(cfg.output_dir) / "vae_logs"),
    )
    meter = ThroughputMeter()
    sched = ExponentialDecay(gamma=args.lr_decay_rate) if cfg.lr_decay else None
    summary = dict(losses=[], temperatures=[], learning_rates=[], usage=[], mesh=dict(mesh.shape),
                   rank=mesh.rank, backend=backend)

    def save(epoch: int) -> None:
        with gathered(vae, opt):  # every rank gathers, rank 0 writes
            if root:
                save_vae_checkpoint(args.output, vae, epoch)
    global_step = 0
    batch_iter = None
    step_losses = []  # each step's (window's) loss, read once at the end

    def assemble(batch):
        """(host tensors of the step's images, pinned on a card; the first
        four images for the recon grid)."""
        return host_tensors({"images": batch["images"]}, on_card), np.asarray(batch["images"][:4])

    for epoch in range(cfg.epochs):
        raw_batches = dataset.batches(cfg.batch_size, shuffle_seed=epoch,
                                      shard=(mesh.data_rank, mesh.data_world))
        batch_iter = Prefetcher(window_iter(raw_batches, steps_per_dispatch),
                                transform=lambda win: [assemble(b) for b in win],
                                depth=cfg.prefetch_depth)
        try:
            for window in batch_iter:
                prev_step = global_step
                # a full window runs as one; an epoch tail step by step
                for part in ([window] if len(window) == steps_per_dispatch
                             else [[one] for one in window]):
                    metrics = run_steps[len(part)](
                        [host for host, _ in part], window_keys(cfg.seed, global_step, len(part)))
                    global_step += len(part)
                    step_losses.append(metrics["loss"])  # a device scalar: no sync here
                r = step_key(cfg.seed, global_step - 1)  # the last step's key
                images_head = window[0][1] if len(window) == steps_per_dispatch else window[-1][1]

                def crossed(interval):
                    return bool(interval) and global_step // interval > prev_step // interval

                log = {}
                if crossed(100):
                    head = torch.as_tensor(images_head, device=device)
                    with torch.no_grad(), gathered(vae):
                        soft = vae(head, temp=temp, generator=generator(r))
                        codes = vae.get_codebook_indices(head)
                        hard = vae.decode(codes)
                    usage = np.bincount(codes.cpu().numpy().ravel(), minlength=cfg.vae.num_tokens)
                    grid = np.concatenate([images_head, soft.cpu().numpy() * 0.5 + 0.5,
                                           hard.cpu().numpy() * 0.5 + 0.5], axis=0)
                    logger.log_images(grid, "orig | soft | hard", "recons", global_step)
                    # one anneal and one decay step per crossed boundary, each
                    # at its boundary's step value
                    for boundary in range(prev_step // 100 + 1, global_step // 100 + 1):
                        temp = max(temp * math.exp(-cfg.vae.anneal_rate * boundary * 100),
                                   cfg.vae.temp_min)
                        if sched is not None:
                            set_learning_rate(opt, sched.step(0.0, get_learning_rate(opt)))
                    log.update(temperature=temp, lr=get_learning_rate(opt),
                               codebook_usage_frac=float((usage > 0).mean()))
                    summary["temperatures"].append((global_step, temp))
                    summary["learning_rates"].append((global_step, get_learning_rate(opt)))
                    summary["usage"].append((global_step, log["codebook_usage_frac"]))

                rate = meter.update(global_step, cfg.batch_size)
                if rate is not None:
                    log["sample_per_sec"] = rate
                if crossed(10):
                    log["loss"] = float(metrics["loss"])
                    summary["losses"].append((global_step, log["loss"]))
                    if root:
                        print(epoch, global_step, f"loss - {log['loss']:.5f}")
                if log:
                    logger.log(log, step=global_step)
        finally:
            batch_iter.close()

        save(epoch)
        if root:
            print(f"epoch {epoch} done; checkpoint -> {args.output}")
        logger.log_model_artifact(args.output, "trained-vae")

    save(cfg.epochs)
    if on_card:
        torch.cuda.synchronize()
    logger.finish()
    summary.update(staged_calls=dict(mesh.comm.staged), collective_calls=dict(mesh.comm.calls),
                   collective_bytes=dict(mesh.comm.bytes))
    if backend is not None:
        host_barrier()
        if not joined:
            dist.destroy_process_group()
    summary.update(global_step=global_step, out_file=args.output, temperature=temp,
                   step_ms=timer.step_ms(),
                   learning_rate=get_learning_rate(opt),
                   last_loss=float(metrics["loss"]) if global_step else None,
                   step_losses=[float(x) for x in step_losses])
    return summary


if __name__ == "__main__":
    main()
