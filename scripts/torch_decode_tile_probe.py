#!/usr/bin/env python3
"""Flash decode's tile arms (`csrc/flash_decode_tile.cu`, bf16 q, and
`csrc/flash_decode_tile_f32.cu`, fp32 q) on one GPU.

The tile arms run flash decode at n > 4 query rows: the flagship prefill
chunk (n = 257 over the 1281-slot cache, lengths 257) and the resume
forward (n = 1280, S = 1281, lengths 1280), B = 4, H = 16, D = 64. This
script builds the kernels (printing ptxas's register and spill lines of
both tile sources), runs `chip_smoke.py`'s phase-2 checks of the tile arms
(against the plain version and each arm's model, poisoned caches,
launches) and of the paged variants, then times kernel 1 and its int8 arm
at both shapes in bf16 and fp32: CUDA events around back-to-back wrapper
calls and device time per call from a torch.profiler trace of the same
calls (12 input copies rotating, as `chip_smoke.py` does), beside SDPA's
causal forward over the live keys in the same dtype.

Run from the repo root on the machine with the card:

    python3 scripts/torch_decode_tile_probe.py [--parent DIR | --ablate]

Prints JSON lines, then the card's nvidia-smi line. With --ablate, copies
of `csrc/flash_decode_tile.cu` that each drop or change one part of the
kernel (`ABLATIONS`; the results of those that drop a part are wrong,
only their times count) are built into `build/ablate_decode_tile/` and
the four timed tile rows are taken through each as device time, in two
rounds of opposite order. With --parent DIR (an
unpacked checkout of another commit, e.g. the parent's `git archive`
under the git-ignored `build/`), only the timed rows run, in separate
processes in turns: DIR's kernels and wrappers, this tree's, this tree's,
DIR's (this script's measuring code each time, so DIR's multi-row arm and
this tree's tile arm meet the same inputs on one card in one call); a
last JSON line gives each turn's device ms.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# (variant, [(text in csrc/flash_decode_tile.cu, its replacement), ...],
# whether its results must equal the source's bit for bit); every
# occurrence of each text is replaced
STAGES, WARPS, BLOCKS = "constexpr int kStages = 2;", "constexpr int kWarps = 8;", "DMAX == 64 ? 2 : 1"
ABLATIONS = (
    ("full", [], True),
    ("three_stages", [(STAGES, STAGES.replace("2", "3"))], True),
    # 64-row blocks of 4 warps, 3 an SM at DMAX 64
    ("four_warps", [(WARPS, WARPS.replace("8", "4")), (BLOCKS, BLOCKS.replace("2", "3"))], True),
    # 128-row blocks of 8 warps, 1 an SM at DMAX 64 (no register cap)
    ("one_block_a_sm", [(BLOCKS, BLOCKS.replace("2", "1"))], True),
    ("no_compute", [("    if (t * kBN >= wkey1) return;", "    if (true) return;")], False),
    ("no_copies", [("  auto fetch = [&](int t, int st) {\n",
                    "  auto fetch = [&](int t, int st) {\n    if (true) return;\n")], False),
)


def load_smoke():
    """This tree's chip_smoke.py as a module, whichever package is first on
    sys.path (its helpers import the port lazily, inside each function)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build() -> None:
    """Build this tree's kernels; print the tile arms' ptxas lines."""
    from dalle_pytorch_tpu_torch import kernels

    kernels.build(["flash_decode", "flash_decode_tile", "flash_decode_tile_f32"])
    for name in ("flash_decode_tile", "flash_decode_tile_f32"):
        info = kernels.build_log[name]
        print(f"build {name}: {info['seconds']:.2f} s")
        entry = ""
        for line in info["ptxas"].splitlines():
            found = re.search(r"Compiling entry function '([^']+)'", line)
            if found:
                entry = found.group(1)
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {entry}: {line.strip()}")


def timed_jobs(torch, cs, dtypes=("bf16", "fp32")):
    """{row: (fn, inputs, iters)}: kernel 1 and its int8 arm at the prefill
    and resume shapes, for bf16 q (the tile arm) and fp32 q (the fp32 tile
    arm; `_f32` rows), and SDPA's causal forward over the live keys in
    each dtype."""
    import torch.nn.functional as F

    from dalle_pytorch_tpu_torch.ops import flash_decode as fd

    b, n_prefill = cs.MAIN["batch"], cs.MAIN["prefill"]

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    jobs = {}
    for key in dtypes:
        dtype, suffix = (torch.bfloat16, "") if key == "bf16" else (torch.float32, "_f32")
        for shape, n, inputs, iters in (
            ("prefill", n_prefill,
             cs.flash_inputs(torch, n_prefill, [n_prefill] * b, dtype, copies=cs.LAYERS),
             10 * cs.LAYERS),
            ("resume", cs.RESUME["n"], cs.resume_inputs(torch, b, dtype, copies=cs.LAYERS),
             2 * cs.LAYERS),
        ):
            int8 = []
            for q, k, v, lens in inputs:
                kq, vq, ks, vs = cs.quantized(torch, k, v)
                int8.append((q, kq, vq, lens, ks, vs))
            live = [(q, k[:, :, :n].contiguous(), v[:, :, :n].contiguous()) for q, k, v, _ in inputs]
            jobs[f"{shape}_{key}"] = (fd.flash_decode_attention, inputs, iters)
            jobs[f"{shape}_int8{suffix}"] = (fd.flash_decode_attention, int8, iters)
            jobs[f"{shape}_sdpa_causal{suffix}"] = (sdpa, live, iters)
    return jobs


def timed_rows(torch, cs):
    """{row: {"event_ms", "device_ms", "device_kernels"}} of timed_jobs."""
    jobs = timed_jobs(torch, cs)
    rows = {name: dict(event_ms=cs.time_ms(torch, fn, inputs, iters))
            for name, (fn, inputs, iters) in jobs.items()}
    for name, (fn, inputs, iters) in jobs.items():  # traces last: they slow later launches
        rows[name]["device_ms"], rows[name]["device_kernels"] = cs.device_ms(torch, fn, inputs, iters)
    return rows


def ablate(torch, cs) -> None:
    """Device ms of the timed tile rows through each ABLATIONS variant, two
    rounds in opposite order."""
    import ctypes

    from dalle_pytorch_tpu_torch import kernels

    src = (kernels.CSRC / "flash_decode_tile.cu").read_text()
    out = REPO / "build" / "ablate_decode_tile"
    out.mkdir(parents=True, exist_ok=True)
    nvcc, procs = kernels.find_nvcc(), {}
    exact = {}
    for name, edits, same in ABLATIONS:
        if any(old not in src for old, _ in edits):
            print(f"ablate {name}: its text is not in the source, skipped")
            continue
        exact[name] = same
        variant = src
        for old, new in edits:
            variant = variant.replace(old, new)
        cu = out / f"{name}.cu"
        cu.write_text(variant)
        procs[name] = subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ablate {name}: nvcc failed\n{log}")
        regs = sorted(set(re.findall(r"Used (\d+) registers", log)), key=int)
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)), key=int)
        print(json.dumps({"ablate": name, "registers": regs, "spill_stores": spills}), flush=True)
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    jobs = {k: job for k, job in timed_jobs(torch, cs, ("bf16",)).items() if "sdpa" not in k}
    def traced_ms(fn, inputs, iters):
        """Device ms a call; a trace that kept no kernel record is taken again
        (after a dozen traces in one process the profiler can drop them all)."""
        for attempt in range(3):
            try:
                return cs.device_ms(torch, fn, inputs, iters)[0]
            except RuntimeError:
                if attempt == 2:
                    raise

    names = list(libs)
    results = {}
    for name in names:  # the variants that keep the arithmetic give the source's bits
        kernels._libs["flash_decode_tile"] = libs[name]
        results[name] = [fn(*inputs[0]) for fn, inputs, _ in jobs.values()]
        if exact[name]:
            same = all(torch.equal(a, b) for a, b in zip(results[name], results["full"]))
            print(json.dumps({"ablate": name, "bit_identical_to_the_source": same}), flush=True)
            if not same:
                raise RuntimeError(f"ablate {name}: results differ from the source's")
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            kernels._libs["flash_decode_tile"] = libs[name]
            row = {job: traced_ms(fn, inputs, iters) for job, (fn, inputs, iters) in jobs.items()}
            print(json.dumps({"ablate": name, "round": rnd, "device_ms": row}), flush=True)
    kernels._libs.pop("flash_decode_tile")


def in_turns(parent: str) -> int:
    """The timed rows of DIR's kernels and this tree's, in turns."""
    turns = []
    for label, tree in (("parent", Path(parent).resolve()), ("change", REPO), ("change", REPO),
                        ("parent", Path(parent).resolve())):
        print(f"--- {label} ({tree})", flush=True)
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--tree", str(tree)],
                             cwd=tree, capture_output=True, text=True, timeout=900)
        print(res.stdout, end="", flush=True)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            print(f"torch_decode_tile_probe: {label} run failed", file=sys.stderr)
            return 1
        rows = json.loads(res.stdout.strip().splitlines()[-1])["rows"]
        turns.append({"tree": label, **{k: r["device_ms"] for k, r in rows.items()}})
    print(json.dumps({"device_ms_turns": turns}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None, help="checkout of another commit to time in turns")
    ap.add_argument("--ablate", action="store_true", help="time variants without each part")
    ap.add_argument("--tree", default=None,
                    help="time this checkout's kernels (timed rows only; used by --parent)")
    args = ap.parse_args()
    if args.parent is not None:
        return in_turns(args.parent)
    sys.path.insert(0, str(Path(args.tree).resolve() if args.tree else REPO))

    import torch

    if not torch.cuda.is_available():
        print("torch_decode_tile_probe: no CUDA device", file=sys.stderr)
        return 1
    cs = load_smoke()
    smi = cs.nvidia_smi_line()
    if args.ablate:
        ablate(torch, cs)
        print(smi)
        return 0
    if args.tree is None:
        build()
        cases = {"prefill": (cs.MAIN["prefill"], [257, 257, 257, 257]),
                 "prefill_edges": (cs.MAIN["prefill"], [257, 320, 1024, 1281])}
        print(json.dumps({"tile_arm_worst_err": cs.check_tile_arm(torch, cases)}), flush=True)
        worst, held = cs.check_paged_variants(torch)
        print(json.dumps({"paged_worst_err": worst, "held": held}), flush=True)
    rows = timed_rows(torch, cs)
    print(smi)
    print(json.dumps({"card": smi, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
