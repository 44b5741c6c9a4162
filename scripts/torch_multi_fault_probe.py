"""Planted faults in `chip_smoke.py` phase 15's multi-process training,
read beside the sound runs: the readings that place the phase's limits
(`MULTI_LOSS_RTOL`, `MULTI_GRAD_RTOL`, `MULTI_UPDATE_RTOL`) between what
a sound sharded run reads and what a broken one reads.

    python3 scripts/torch_multi_fault_probe.py [--out chiprun_out/multi_fault_probe.json]

    python3 scripts/torch_multi_fault_probe.py --runs vae_fsdp2   # the dVAE's runs only

Needs one CUDA card. It runs phase 15's three one-process references
(the flash model, the ring model and the pipeline's `--exp ff` scan
model) in this process, then one launch of two ranks on the card
(`python -m dalle_pytorch_tpu_torch.launch --nproc_per_host 2`) whose
ranks run, in turn, the sound fsdp = 2, ring sp = 2, tp = 2, pp = 2 and
dVAE fsdp = 2 runs and one run for each planted fault (`--runs` keeps
the named runs only; a dVAE run's reference is its own global batches
stepped again in this process, `chip_smoke.multi_vae_replay`):

  no_div       the gradients summed over the data ranks, not averaged
  unreduced    no gradient all-reduce after the backward (the whole
               leaves keep each rank's own gradient)
  half_batch   rank 1's rows give no gradient
  sign         the averaged gradient negated
  no_last_hop  the ring's backward leaves each dk / dv block one rank
               short of home
  no_g         tp: the row-parallel outputs and the embeddings not summed
               over tp (Megatron's g skipped)
  no_f_back    tp: the input gradient of a column-parallel layer not
               summed over tp (f's backward skipped)
  bias_twice   tp: a row-parallel layer's bias added twice
  pipe_drop    pp: the last hop of each pass of the schedule arrives as
               zeros
  pipe_order   pp: the first stage feeds the microbatches in reverse
               order
  noise_swap   the dVAE: each data rank takes the other rank's rows of
               the global batch's Gumbel noise

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


def no_g():
    from dalle_pytorch_tpu_torch.parallel import tensor_parallel

    return patched(tensor_parallel, "reduce_from_group", lambda reduce: lambda x, comm, group: x)


@contextmanager
def no_f_back():
    from dalle_pytorch_tpu_torch.parallel.collectives import _CopyToGroup

    kept = _CopyToGroup.__dict__["backward"]
    _CopyToGroup.backward = staticmethod(lambda ctx, grad: (grad, None, None))
    try:
        yield
    finally:
        _CopyToGroup.backward = kept


def bias_twice():
    from dalle_pytorch_tpu_torch.parallel import tensor_parallel

    def make(row):
        def _row(lin, comm, group):
            forward = row(lin, comm, group)
            return lambda x: (lambda y: y + lin.bias.to(y.dtype))(forward(x))

        return _row

    return patched(tensor_parallel, "_row", make)


def pipe_drop():
    import torch

    from dalle_pytorch_tpu_torch.parallel.collectives import Collectives

    got = [0]

    def make(shift):
        def pipe_shift(self, t, group, dst=None, src=None, like=None, **kw):
            out = shift(self, t, group, dst=dst, src=src, like=like, **kw)
            if out is not None:
                got[0] += 1
                if got[0] % cs_pp_micro() == 0:  # each pass's last receive
                    return torch.zeros_like(out)
            return out

        return pipe_shift

    return patched(Collectives, "pipe_shift", make)


def pipe_order():
    from dalle_pytorch_tpu_torch.parallel import gpipe

    return patched(gpipe, "_slot", lambda slot: lambda t, n: slot(t, n)[::-1])


def noise_swap():
    from dalle_pytorch_tpu_torch.training import steps

    # the global draw's halves swapped: each rank's slice is the other's rows
    return patched(steps, "gumbel_noise",
                   lambda draw: lambda shape, *a, **kw: draw(shape, *a, **kw).roll(shape[0] // 2, 0))


def cs_pp_micro():
    import chip_smoke as cs

    return cs.MULTI_PP_MICRO


PLANTS = {"none": nullcontext, "no_div": no_div, "unreduced": unreduced, "half_batch": half_batch,
          "sign": sign, "no_last_hop": no_last_hop, "no_g": no_g, "no_f_back": no_f_back,
          "bias_twice": bias_twice, "pipe_drop": pipe_drop, "pipe_order": pipe_order,
          "noise_swap": noise_swap}
#: (the sharded run, the planted fault), in the launch's order
RUNS = [("fsdp2", "none"), ("ring_sp2", "none"), ("tp2", "none"), ("pp2", "none"), ("vae_fsdp2", "none"),
        ("fsdp2", "no_div"), ("fsdp2", "unreduced"), ("fsdp2", "half_batch"), ("fsdp2", "sign"),
        ("ring_sp2", "no_last_hop"), ("tp2", "no_g"), ("tp2", "no_f_back"), ("tp2", "bias_twice"),
        ("pp2", "pipe_drop"), ("pp2", "pipe_order"), ("vae_fsdp2", "unreduced"),
        ("vae_fsdp2", "noise_swap")]


def train_rank(argv):
    """A rank's command: `--train-rank OUT --plants a,b,... -- <runs>`."""
    import chip_smoke as cs

    out, names, rest = argv[0], argv[2].split(","), argv[argv.index("--") + 1:]
    return cs.train_rank([out, "--", *rest], plant=lambda i: PLANTS[names[i]]())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "multi_fault_probe.json"))
    ap.add_argument("--timeout", type=float, default=1500)
    ap.add_argument("--runs", default=None, help="comma-separated run names to keep (default: all)")
    opts = ap.parse_args()
    chosen = [(name, plant) for name, plant in RUNS
              if opts.runs is None or name in opts.runs.split(",")]

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import shutil

    import chip_smoke as cs

    smi = cs.nvidia_smi_line()
    run_dir = REPO / "build" / "multi_fault_probe"
    steps = cs.MULTI_SAMPLES // 4
    pp = list(cs.MULTI_PP_FLAGS)
    flags = {
        "fsdp2": (2, ["--set", "mesh.fsdp=2"], []),
        "ring_sp2": (4, ["--set", "mesh.sp=2", "--set", "model.attn_impl=ring"],
                     ["--set", "model.attn_impl=ring"]),
        "tp2": (4, ["--set", "mesh.tp=2"], []),
        "pp2": (4, [*pp, "--set", "mesh.pp=2", "--set", f"mesh.pp_micro={cs.MULTI_PP_MICRO}"], pp),
    }
    refs_of = {"fsdp2": "fsdp2", "ring_sp2": "ring_sp2", "tp2": "fsdp2", "pp2": "pp2"}
    used = {refs_of[name] for name, _ in chosen if name in refs_of}
    t0 = time.perf_counter()
    try:
        with cs.cli_precision(torch):
            vae_path = cs.multi_setup(torch, run_dir)
            refs = {name: cs.multi_one_process(torch, cs.multi_trainer_args(
                run_dir / f"ref_{name}", vae_path, 4, *ref, "--set", "log_images_freq=0"))
                for name, (_, _, ref) in flags.items() if name in used}

            def args(i, name, plant):
                if name == "vae_fsdp2":
                    return cs.multi_vae_args(run_dir / f"{i}_{name}_{plant}", 2, "--set", "mesh.fsdp=2")
                return cs.multi_trainer_args(run_dir / f"{i}_{name}_{plant}", vae_path, flags[name][0],
                                             *flags[name][1], "--set", "log_images_freq=0")

            runs = [args(i, name, plant) for i, (name, plant) in enumerate(chosen)]
            out = run_dir / "ranks"
            records = cs.launch_ranks(
                out, runs, rank_cmd=[str(Path(__file__).resolve()), "--train-rank", str(out), "--plants",
                                     ",".join(plant for _, plant in chosen)],
                timeout=opts.timeout)
            readings = []
            for i, ((name, plant), ranks) in enumerate(zip(chosen, records)):
                ref = (cs.multi_vae_replay(torch, ranks, run_dir / f"{i}_replay.npz")
                       if name == "vae_fsdp2" else refs[refs_of[name]])
                readings.append(dict(run=name, plant=plant, **cs.multi_readings(ref, ranks)))
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
