"""Planted faults in `chip_smoke.py` phase 15's multi-process training,
read beside the sound runs: the readings that place the phase's limits
(`MULTI_LOSS_RTOL`, `MULTI_GRAD_RTOL`, `MULTI_UPDATE_RTOL`) between what
a sound sharded run reads and what a broken one reads.

    python3 scripts/torch_multi_fault_probe.py [--out chiprun_out/multi_fault_probe.json]

Needs one CUDA card. It runs phase 15's two one-process references (the
flash model and the ring model) in this process, then one launch of two
ranks on the card (`python -m dalle_pytorch_tpu_torch.launch
--nproc_per_host 2`) whose ranks run, in turn, the sound fsdp = 2 and
ring sp = 2 runs and one run for each planted fault:

  no_div       the gradients summed over the data ranks, not averaged
  unreduced    no gradient all-reduce after the backward (the whole
               leaves keep each rank's own gradient)
  half_batch   rank 1's rows give no gradient
  sign         the averaged gradient negated
  no_last_hop  the ring's backward leaves each dk / dv block one rank
               short of home

A fault is planted in the rank process by patching one function of the
port for the length of its run; nothing in the package changes. Each
run's readings are `chip_smoke.multi_readings` against its reference;
they are printed and written as JSON to `--out`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


@contextmanager
def patched(owner, name, make):
    """`owner.name` replaced by `make(original)` inside the block."""
    kept = getattr(owner, name)
    setattr(owner, name, make(kept))
    try:
        yield
    finally:
        setattr(owner, name, kept)


def _after_reduce(change):
    from dalle_pytorch_tpu_torch.parallel.fsdp import FSDP

    def make(reduce):
        def reduce_gradients(self):
            reduce(self)
            for p in self.model.parameters():
                if p.grad is not None:
                    change(self, p.grad)

        return reduce_gradients

    return patched(FSDP, "reduce_gradients", make)


def no_div():
    return _after_reduce(lambda fsdp, g: g.mul_(fsdp.mesh.data_world))


def sign():
    return _after_reduce(lambda fsdp, g: g.neg_())


def unreduced():
    from dalle_pytorch_tpu_torch.parallel.fsdp import FSDP

    return patched(FSDP, "_all_reduce_flat", lambda reduce: lambda self, tensors, group: None)


def half_batch():
    import torch.distributed as dist

    from dalle_pytorch_tpu_torch.training import steps

    def make(make_loss):
        def make_dalle_loss(*args, **kwargs):
            loss_fn = make_loss(*args, **kwargs)

            def zeroed(*a, **kw):
                loss, metrics = loss_fn(*a, **kw)
                return (loss * 0 if dist.get_rank() == 1 else loss), metrics

            return zeroed

        return make_dalle_loss

    return patched(steps, "make_dalle_loss", make)


def no_last_hop():
    from dalle_pytorch_tpu_torch.parallel.collectives import Collectives

    hops = [0]

    def make(shift):
        def ring_shift(self, t, group, ranks, index):
            if t.shape[0] == 4:  # the backward's [k, v, dk, dv] block
                hops[0] += 1
                if hops[0] % len(ranks) == 0:
                    return t
            return shift(self, t, group, ranks, index)

        return ring_shift

    return patched(Collectives, "ring_shift", make)


PLANTS = {"none": nullcontext, "no_div": no_div, "unreduced": unreduced, "half_batch": half_batch,
          "sign": sign, "no_last_hop": no_last_hop}
#: (the sharded run, the planted fault), in the launch's order
RUNS = [("fsdp2", "none"), ("ring_sp2", "none"), ("fsdp2", "no_div"), ("fsdp2", "unreduced"),
        ("fsdp2", "half_batch"), ("fsdp2", "sign"), ("ring_sp2", "no_last_hop")]


def train_rank(argv):
    """A rank's command: `--train-rank OUT --plants a,b,... -- <runs>`."""
    import chip_smoke as cs

    out, names, rest = argv[0], argv[2].split(","), argv[argv.index("--") + 1:]
    return cs.train_rank([out, "--", *rest], plant=lambda i: PLANTS[names[i]]())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "multi_fault_probe.json"))
    ap.add_argument("--timeout", type=float, default=900)
    opts = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import shutil

    import chip_smoke as cs

    smi = cs.nvidia_smi_line()
    run_dir = REPO / "build" / "multi_fault_probe"
    steps = cs.MULTI_SAMPLES // 4
    flags = {
        "fsdp2": (2, ["--set", "mesh.fsdp=2"], []),
        "ring_sp2": (4, ["--set", "mesh.sp=2", "--set", "model.attn_impl=ring"],
                     ["--set", "model.attn_impl=ring"]),
    }
    t0 = time.perf_counter()
    try:
        with cs.cli_precision(torch):
            vae_path = cs.multi_setup(torch, run_dir)
            refs = {name: cs.multi_one_process(torch, cs.multi_trainer_args(
                run_dir / f"ref_{name}", vae_path, 4, *ref, "--set", "log_images_freq=0"))
                for name, (_, _, ref) in flags.items()}
            runs = [cs.multi_trainer_args(run_dir / f"{i}_{name}_{plant}", vae_path, flags[name][0],
                                          *flags[name][1], "--set", "log_images_freq=0")
                    for i, (name, plant) in enumerate(RUNS)]
            out = run_dir / "ranks"
            records = cs.launch_ranks(
                out, runs, rank_cmd=[str(Path(__file__).resolve()), "--train-rank", str(out), "--plants",
                                     ",".join(plant for _, plant in RUNS)],
                timeout=opts.timeout)
            readings = [dict(run=name, plant=plant, **cs.multi_readings(refs[name], ranks))
                        for (name, plant), ranks in zip(RUNS, records)]
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    keys = ("loss_max_rel_diff", "grad_rel_diff", "grad_worst_rel_diff", "update_rel_diff",
            "update_worst_rel_diff", "param_max_abs_diff")
    for r in readings:
        print(f"{r['run']:9s} {r['plant']:12s} " + "  ".join(f"{k} {r[k]:.3e}" for k in keys))
    summary = {"card": smi, "steps": steps, "seconds": time.perf_counter() - t0,
               "limits": {"loss_rtol": cs.MULTI_LOSS_RTOL, "grad_rtol": cs.MULTI_GRAD_RTOL,
                          "update_rtol": cs.MULTI_UPDATE_RTOL},
               "readings": readings}
    Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
    Path(opts.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: summary[k] for k in ("card", "seconds", "limits")}))
    print(smi)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-rank"]:
        sys.exit(train_rank(sys.argv[2:]))
    sys.exit(main())
