#!/usr/bin/env python3
"""The flash-decode kernels at the flagship decode step, on one GPU.

At the flagship step (n = 1, B = 4, H = 16, D = 64, bf16, lengths [258,
700, 1024, 1281]) it times, with CUDA events around back-to-back wrapper
calls and as device time per call from a torch.profiler trace of the same
calls (12 input copies rotating, as `chip_smoke.py` does):

* kernel 1 (`flash_decode_attention`) on a contiguous cache, and kernel 2
  (its int8 arm);
* kernel 3 (`block_sparse_flash_decode_attention`) with the axial_row
  policy's bitmap (128-position blocks);
* kernel 4 (`paged_flash_decode_attention`) through 32-position pages of a
  shuffled 206-page pool, its int8 arm, and kernel 1 on the same pool's
  gathered view;
* kernel 5 (`block_sparse_paged_flash_decode_attention`) with that bitmap
  re-expanded to pages, and its int8 arm.

Then, by page size (16-128) and table order (shuffled, in order), the
paged kernel against kernel 1 on the gathered view (event times), checking
that the two are bit-identical.

Run from the repo root on the machine with the card:

    python3 scripts/torch_paged_probe.py [--parent DIR | --ablate]

Prints JSON lines, then the card's nvidia-smi line. With --ablate, copies
of `csrc/flash_decode.cu` that each drop or change one part of the kernel
(`ABLATIONS`; the results of most are wrong, only their times count), and
other split-K spans, are built into `build/ablate_decode/` and kernels
1, 4 and 5 (int8) are timed through each as device time, in two rounds of
opposite order: what each part costs. With --parent DIR (an
unpacked checkout of another commit, e.g. the parent's `git archive` under
the git-ignored `build/`), only the flagship rows run, in separate
processes in turns: DIR's kernels and wrappers, this tree's, this tree's,
DIR's (this script's measuring code each time), so both are measured on
one card in one call; a last JSON line gives each turn's device ms.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
LENGTHS = [258, 700, 1024, 1281]

# (variant, text in csrc/flash_decode.cu, its replacement); every
# occurrence is replaced
SPAN = "constexpr int kSpan = 128;"
ABLATIONS = (
    ("full", "", ""),
    ("no_combine", "  if (!last_block) return;", "  if (true) return;"),
    ("no_compute", "    if (t * BN + warp * KPW >= key1) return;  // warp-uniform",
     "    if (true) return;"),
    ("no_copies", "      if (t * BN + jw >= key1) break;  // warp-uniform: keys ascend",
     "      if (true) break;"),
    ("two_stages", "constexpr int kStages = 3;", "constexpr int kStages = 2;"),
    ("four_stages", "constexpr int kStages = 3;", "constexpr int kStages = 4;"),
    ("no_split", "int grid_spans(int n, int S) { return n <= kRows ? (S + kSpan - 1) / kSpan : 1; }",
     "int grid_spans(int n, int S) { return 1; }"),
    ("span=64", SPAN, SPAN.replace("128", "64")),
    ("span=256", SPAN, SPAN.replace("128", "256")),
    ("span=512", SPAN, SPAN.replace("128", "512")),
)


def load_smoke():
    """This tree's chip_smoke.py as a module, whichever package is first on
    sys.path (its helpers import the port lazily, inside each function)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def flagship_rows(torch, cs):
    """{row: {"event_ms", "device_ms", "device_kernels"}} at the flagship step."""
    from dalle_pytorch_tpu_torch.ops import flash_decode as fd

    vlen, iters, page, pool = cs.MAIN["cache"], 40 * cs.LAYERS, cs.PAGE, cs.PAGED_POOL
    contiguous = cs.flash_inputs(torch, 1, LENGTHS, torch.bfloat16, copies=cs.LAYERS)
    positions = [x - (cs.FLAGSHIP["text_seq_len"] + 1) - 1 for x in LENGTHS]
    bm = torch.tensor(cs.policy_bitmaps(("axial_row",), positions)[0], device="cuda")
    sets = [cs.paged_case(torch, 4, cs.MAIN["heads"], 1, cs.MAIN["dim_head"], page, LENGTHS,
                          torch.bfloat16, vlen, cs.SEED + i, n_pool=pool)[:5]
            for i in range(cs.LAYERS)]
    page_bm = fd.page_bitmap(bm, 128, page, -(-vlen // page))

    def int8(q, k, v, *rest):
        kq, vq, ks, vs = cs.quantized(torch, k, v)
        return (q, kq, vq, *rest), (ks, vs)

    jobs = {
        "kernel1": (fd.flash_decode_attention, contiguous),
        "kernel2_int8": (fd.flash_decode_attention,
                         [a + s for a, s in (int8(*x) for x in contiguous)]),
        "kernel3_axial_row": (fd.block_sparse_flash_decode_attention,
                              [x + (bm, 128) for x in contiguous]),
        "kernel4": (fd.paged_flash_decode_attention, sets),
        "kernel4_int8": (fd.paged_flash_decode_attention,
                         [a + s for a, s in (int8(*x) for x in sets)]),
        "kernel1_on_gathered_pool": (fd.flash_decode_attention, [
            (q, fd.paged_gather(k, t, vlen), fd.paged_gather(v, t, vlen), lens)
            for q, k, v, lens, t in sets]),
        "kernel5_axial_row": (fd.block_sparse_paged_flash_decode_attention,
                              [x + (page_bm,) for x in sets]),
        "kernel5_axial_row_int8": (fd.block_sparse_paged_flash_decode_attention,
                                   [a + (page_bm,) + s for a, s in (int8(*x) for x in sets)]),
    }
    rows = {name: dict(event_ms=cs.time_ms(torch, fn, inputs, iters))
            for name, (fn, inputs) in jobs.items()}
    for name, (fn, inputs) in jobs.items():  # traces last: they slow later launches
        rows[name]["device_ms"], rows[name]["device_kernels"] = cs.device_ms(torch, fn, inputs, iters)
    return rows


def by_page(torch, cs):
    """The paged kernel against kernel 1 on the gathered view, by page size
    and table order; False if the two ever differ."""
    from dalle_pytorch_tpu_torch.ops import flash_decode as fd

    vlen, iters = cs.MAIN["cache"], 40 * cs.LAYERS
    for page in (16, 32, 64, 128):
        n_pages = -(-vlen // page)
        shuffled = [
            cs.paged_case(torch, 4, cs.MAIN["heads"], 1, cs.MAIN["dim_head"], page, LENGTHS,
                          torch.bfloat16, vlen, seed)[:5]
            for seed in range(cs.LAYERS)
        ]
        in_order = torch.arange(1, 1 + 4 * n_pages, dtype=torch.int32, device="cuda").view(4, n_pages)
        ordered = [(q, k, v, lens, in_order) for q, k, v, lens, _ in shuffled]
        gathered = [
            (q, fd.paged_gather(k, t, vlen), fd.paged_gather(v, t, vlen), lens)
            for q, k, v, lens, t in shuffled
        ]
        same = all(
            torch.equal(fd.paged_flash_decode_attention(*p), fd.flash_decode_attention(*g))
            for p, g in zip(shuffled, gathered)
        )
        print(json.dumps(dict(
            page=page,
            kernel1_ms=cs.time_ms(torch, fd.flash_decode_attention, gathered, iters),
            paged_shuffled_ms=cs.time_ms(torch, fd.paged_flash_decode_attention, shuffled, iters),
            paged_in_order_ms=cs.time_ms(torch, fd.paged_flash_decode_attention, ordered, iters),
            paged_equals_kernel1=same,
        )), flush=True)
        if not same:
            return False
    return True


def ablate(torch, cs) -> None:
    """Device ms of kernels 1, 4 and 5 (int8) at the flagship step through
    each ABLATIONS variant, two rounds in opposite order."""
    import ctypes

    from dalle_pytorch_tpu_torch import kernels
    from dalle_pytorch_tpu_torch.ops import flash_decode as fd

    src = (kernels.CSRC / "flash_decode.cu").read_text()
    out = REPO / "build" / "ablate_decode"
    out.mkdir(parents=True, exist_ok=True)
    nvcc, procs = kernels.find_nvcc(), {}
    for name, old, new in ABLATIONS:
        if old and old not in src:
            print(f"ablate {name}: its text is not in the source, skipped")
            continue
        cu = out / f"{name}.cu"
        cu.write_text(src.replace(old, new) if old else src)
        procs[name] = subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ablate {name}: nvcc failed\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    vlen, iters, page = cs.MAIN["cache"], 40 * cs.LAYERS, cs.PAGE
    contiguous = cs.flash_inputs(torch, 1, LENGTHS, torch.bfloat16, copies=cs.LAYERS)
    sets = [cs.paged_case(torch, 4, cs.MAIN["heads"], 1, cs.MAIN["dim_head"], page, LENGTHS,
                          torch.bfloat16, vlen, cs.SEED + i, n_pool=cs.PAGED_POOL)[:5]
            for i in range(cs.LAYERS)]
    positions = [x - (cs.FLAGSHIP["text_seq_len"] + 1) - 1 for x in LENGTHS]
    bm = torch.tensor(cs.policy_bitmaps(("axial_row",), positions)[0], device="cuda")
    page_bm = fd.page_bitmap(bm, 128, page, -(-vlen // page))
    sparse_int8 = []
    for q, k, v, lens, t in sets:
        kq, vq, ks, vs = cs.quantized(torch, k, v)
        sparse_int8.append((q, kq, vq, lens, t, page_bm, ks, vs))
    jobs = {"kernel1": (fd.flash_decode_attention, contiguous),
            "kernel4": (fd.paged_flash_decode_attention, sets),
            "kernel5_int8": (fd.block_sparse_paged_flash_decode_attention, sparse_int8)}
    names = list(libs)
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            kernels._libs["flash_decode"] = libs[name]
            row = {job: cs.device_ms(torch, fn, inputs, iters)[0] for job, (fn, inputs) in jobs.items()}
            print(json.dumps({"ablate": name, "round": rnd, "device_ms": row}), flush=True)
    kernels._libs.pop("flash_decode")


def in_turns(parent: str) -> int:
    """The flagship rows of DIR's kernels and this tree's, in turns."""
    turns = []
    for label, tree in (("parent", Path(parent).resolve()), ("change", REPO), ("change", REPO),
                        ("parent", Path(parent).resolve())):
        print(f"--- {label} ({tree})", flush=True)
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--tree", str(tree)],
                             cwd=tree, capture_output=True, text=True, timeout=900)
        print(res.stdout, end="", flush=True)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            print(f"torch_paged_probe: {label} run failed", file=sys.stderr)
            return 1
        rows = json.loads(res.stdout.strip().splitlines()[-1])["flagship"]
        turns.append({"tree": label, **{k: r["device_ms"] for k, r in rows.items()}})
    print(json.dumps({"device_ms_turns": turns}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None, help="checkout of another commit to time in turns")
    ap.add_argument("--ablate", action="store_true", help="time variants without each part")
    ap.add_argument("--tree", default=None,
                    help="time this checkout's kernels (flagship rows only; used by --parent)")
    args = ap.parse_args()
    if args.parent is not None:
        return in_turns(args.parent)
    sys.path.insert(0, str(Path(args.tree).resolve() if args.tree else REPO))

    import torch

    if not torch.cuda.is_available():
        print("torch_paged_probe: no CUDA device", file=sys.stderr)
        return 1
    cs = load_smoke()
    smi = cs.nvidia_smi_line()
    if args.ablate:
        ablate(torch, cs)
        print(smi)
        return 0
    if args.tree is None and not by_page(torch, cs):
        print("torch_paged_probe: the paged kernel differs from kernel 1", file=sys.stderr)
        return 1
    rows = flagship_rows(torch, cs)
    print(smi)
    print(json.dumps({"card": smi, "lengths": LENGTHS, "flagship": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
