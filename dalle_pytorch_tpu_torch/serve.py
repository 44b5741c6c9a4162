"""Serve a trained DALL-E checkpoint over HTTP, on the card (the port's twin
of the repository's `serve.py`).

    python -m dalle_pytorch_tpu_torch.serve --dalle_path dalle.npz --port 8000 \\
        [--engine continuous] [--device cpu]
    curl -s localhost:8000/generate -d '{"prompt": "small red circle"}'
    curl -s localhost:8000/metrics

    # a fleet: replicas, one of them supervised, behind a router
    python -m dalle_pytorch_tpu_torch.serve --dalle_path dalle.npz --engine continuous \\
        --port 8001 --checkpoint_spool spool_b --supervise --spool_notify http://127.0.0.1:8100
    python -m dalle_pytorch_tpu_torch.serve --router --port 8100 \\
        --replicas a=http://127.0.0.1:8000,b=http://127.0.0.1:8001 --migrate_wait_s 60

Loads the checkpoint through `serving/engine.py:engine_from_checkpoint`
(the micro `GenerationEngine`, or with `--engine continuous` the
`ContinuousEngine`, paged with `--kv_layout paged`, and with `--mesh tp=N`
its tensor-parallel twin over N devices, `serving/sharded.py`), warms it
up, and
serves it with `serving/server.py:ServingServer` (the wire protocol is
there). Prints `[serve] listening on http://HOST:PORT ...` once ready; the
first SIGTERM or SIGINT drains the queue and exits 0, a second exits at
once. Lifecycle events and one line per request go to stdout as JSON
(`obs/logging.py`). Runs on the card unless `--device cpu`.

The vitals sampler, stall watchdog and per-program cost table
(`obs/vitals.py`: `/debug/vitals`, `/debug/programs`) are on unless
`--no_vitals` / `--no_program_costs`; `--slo_ttft_ms` / `--slo_request_ms`
add SLO burn tracking. `--router` runs the fleet router
(`serving/router.py`) in front of `--replicas` instead of a replica, and
`--supervise` runs this replica under the crash-fast supervisor
(`serving/supervisor.py`), which hands its `--checkpoint_spool` to the
router at `--spool_notify` after a restart. Both dispatch before torch is
imported: those processes never touch the card. `DALLE_SERVE_CRASH=
program:nth` in the environment aborts the replica at the nth dispatch of
`program` (restart drills).

`--compile_cache DIR` boots against the kernel-library compile cache
(`utils/compile_cache.py`), installed before anything builds: a replica
restarted with the same fingerprint loads every library from DIR and runs
no nvcc; a stale or damaged artifact is a counted miss or reject and the
library is built or loaded from the build directory instead. `POST
/debug/profile?seconds=N` writes a `torch.profiler` Chrome trace under
`--profile_dir`. `--trace_export URL` ships finished request traces to a
fleet collector (`python -m dalle_pytorch_tpu_torch.obs.collector`); it
needs the tracer, so `--no_tracing` refuses it.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import signal
import sys
import threading
from typing import Optional, Sequence


def parse_tenant_weights(text):
    """'a=4,b=1' -> {"a": 4.0, "b": 1.0}; raises ValueError on junk."""
    out = {}
    for pair in (text or "").split(","):
        if not pair:
            continue
        tenant, sep, weight = pair.partition("=")
        if not sep or not tenant:
            raise ValueError(f"expected tenant=weight, got {pair!r}")
        w = float(weight)
        if w <= 0:
            raise ValueError(f"tenant {tenant!r} weight must be > 0")
        out[tenant] = w
    return out


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    from dalle_pytorch_tpu_torch.serving.router import add_router_args

    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter, allow_abbrev=False
    )
    p.add_argument("--dalle_path", type=str, default=None,
                   help="DALL-E checkpoint to serve (required unless --router)")
    p.add_argument("--router", action="store_true",
                   help="run the replica fleet router in front of --replicas instead of a replica "
                   "(no checkpoint, no torch, no card)")
    add_router_args(p, require_replicas=False)
    p.add_argument("--clip_path", type=str, default=None, help="CLIP checkpoint enabling rerank=true requests")
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000, help="0 picks a free port")
    p.add_argument("--batch_shapes", type=str, default="1,4,8",
                   help="comma-separated batch sizes; a micro-batch is padded up to the nearest "
                   "(continuous: the slot count is the largest)")
    p.add_argument("--max_delay_ms", type=float, default=25.0,
                   help="micro-batch flush deadline from the oldest request")
    p.add_argument("--engine", choices=("micro", "continuous"), default="micro",
                   help="micro: padded micro-batches, one whole decode per flush; continuous: "
                   "admission at chunk boundaries over cache slots (cond_scale must be 1)")
    p.add_argument("--chunk_tokens", type=int, default=4, help="continuous: tokens per chunk dispatch")
    p.add_argument("--prefill_batch", type=int, default=4,
                   help="continuous: prompts admitted per prefill dispatch (clamped to the slots)")
    p.add_argument("--kv_layout", choices=("slot", "paged"), default="slot",
                   help="continuous cache layout: one full-length lane per slot, or a page pool "
                   "with page tables and a prefix cache")
    p.add_argument("--page_size", type=int, default=32, help="paged: tokens per KV page")
    p.add_argument("--kv_pages", type=int, default=None,
                   help="paged: pages in the pool (default: the slotted worst case plus one row "
                   "of prefix-cache room; fewer pages make admission wait for free pages)")
    p.add_argument("--prefix_entries", type=int, default=64,
                   help="paged: prompts kept in the prefix cache (0 turns it off)")
    p.add_argument("--kv_dtype", choices=("model", "int8"), default="model",
                   help="KV-cache storage: the model's dtype, or int8 with per-(position, head) "
                   "fp32 scales")
    p.add_argument("--decode_sparsity", choices=("causal", "policy"), default="causal",
                   help="continuous: dense-causal flash decode, or block-sparse decode from the "
                   "model's static attention layouts")
    p.add_argument("--mesh", type=str, default=None, metavar="AXES",
                   help="continuous: serve one engine sharded over a device mesh, axis=size pairs "
                   "over dp/fsdp/tp/sp (e.g. 'tp=2'; one size may be -1 for the remaining devices): "
                   "heads, FF hidden units and vocabularies split over tp; dp, fsdp and sp must be 1")
    p.add_argument("--max_queue", type=int, default=64, help="queue bound in rows; beyond it 503")
    p.add_argument("--request_timeout_s", type=float, default=120.0)
    p.add_argument("--no_preempt", action="store_true",
                   help="continuous: no decode-time priority preemption")
    p.add_argument("--no_shed", action="store_true",
                   help="continuous: no deadline shedding at admission")
    p.add_argument("--tenant_quota_rows", type=int, default=None,
                   help="per-tenant cap on queued rows; past it 429 + Retry-After")
    p.add_argument("--tenant_weights", type=str, default=None, metavar="T=W,...",
                   help="per-tenant admission shares within each class, e.g. 'a=4,b=1'")
    p.add_argument("--reserve_slots", type=int, default=0,
                   help="continuous: cache slots only the high class may use")
    p.add_argument("--replica_quarantine_after", type=int, default=2,
                   help="a request in flight for this many consecutive failed dispatches gets a "
                   "terminal 422 with the incident ids (0 turns it off)")
    p.add_argument("--cond_scale", type=float, default=1.0)
    p.add_argument("--no_warmup", action="store_true",
                   help="skip the warmup (the first request pays the kernel builds)")
    p.add_argument("--compile_cache", type=str, default=None, metavar="DIR",
                   help="kernel-library compile cache: libraries are loaded from fingerprinted artifacts "
                   "under DIR (validated against torch, CUDA, nvcc, the device, the sources, the model "
                   "config and the program ladder) and what is built is exported there, so a restarted "
                   "replica runs no nvcc; a mismatched or corrupt artifact is a counted miss or reject "
                   "and a normal build, never a failed boot")
    p.add_argument("--no_resume", action="store_true",
                   help="continuous: preempted and migrated rows decode again from 0 instead of "
                   "resuming at their position")
    p.add_argument("--checkpoint_spool", type=str, default=None, metavar="DIR",
                   help="continuous: journal in-flight decode-state checkpoints to DIR every "
                   "--spool_every chunks")
    p.add_argument("--spool_every", type=int, default=8, help="chunks between spool writes")
    p.add_argument("--preview_every", type=int, default=4,
                   help="streamed /generate: chunks between preview events (0: none)")
    p.add_argument("--verbose", action="store_true", help="HTTP access logs")
    p.add_argument("--trace_dump", "--trace-dump", dest="trace_dump", type=str, default=None, metavar="PATH",
                   help="write the request-trace ring as Perfetto JSON to PATH at shutdown")
    p.add_argument("--trace_ring", type=int, default=256, help="recent request traces kept in memory")
    p.add_argument("--no_tracing", action="store_true", help="no request span tracer")
    p.add_argument("--trace_export", type=str, default=None, metavar="URL",
                   help="ship finished request traces to a fleet trace collector (python -m "
                   "dalle_pytorch_tpu_torch.obs.collector) at URL as batched JSONL: bounded buffer and "
                   "backoff, serving is unaffected when the collector is down")
    p.add_argument("--trace_site", type=str, default=None, metavar="NAME",
                   help="process identity of traces and log lines (default: the hostname)")
    p.add_argument("--profile_dir", type=str, default="profiles",
                   help="where POST /debug/profile?seconds=N writes its torch.profiler trace directories")
    p.add_argument("--no_request_log", action="store_true", help="no JSON line per request")
    p.add_argument("--request_log_path", type=str, default=None, metavar="FILE",
                   help="write the JSON lines to FILE (appended) instead of stdout")
    p.add_argument("--request_log_max_mb", type=float, default=None, metavar="MB",
                   help="rotate --request_log_path to FILE.1 past MB megabytes")
    p.add_argument("--supervise", action="store_true",
                   help="run this replica under the crash-fast supervisor: restarted on an abnormal "
                   "exit with capped exponential backoff and crash-loop hold-down, readiness gated on "
                   "its /healthz (needs an explicit --port)")
    p.add_argument("--spool_notify", type=str, default=None, metavar="URL",
                   help="with --supervise: the router's base URL the supervisor POSTs the crash "
                   "spool to (/admin/spool) once the restarted replica is ready")
    p.add_argument("--no_vitals", action="store_true",
                   help="no vitals sampler (and with it no stall watchdog or SLO burn)")
    p.add_argument("--vitals_interval_s", type=float, default=1.0,
                   help="seconds between vitals samples and watchdog checks")
    p.add_argument("--no_program_costs", action="store_true",
                   help="no per-program cost table (/debug/programs and the MFU gauges stay empty)")
    p.add_argument("--slo_ttft_ms", type=float, default=None,
                   help="time-to-first-token SLO target in ms (continuous engine)")
    p.add_argument("--slo_request_ms", type=float, default=None, help="request latency SLO target in ms")
    p.add_argument("--slo_objective", type=float, default=0.99,
                   help="fraction of requests that must meet each SLO target")
    p.add_argument("--slo_window_s", type=float, default=300.0, help="rolling window of the SLO burn rate")
    args = p.parse_args(argv)
    if args.supervise:
        if args.router:
            p.error("--supervise supervises an engine replica; run the router under its own process manager")
        if args.port == 0:
            p.error("--supervise needs an explicit --port (the supervisor probes http://host:port/healthz "
                    "for readiness; port 0 would pick a fresh one per restart)")
    if args.spool_notify is not None and not args.supervise:
        p.error("--spool_notify is the supervisor's hand-off hook; it needs --supervise")
    if args.spool_notify is not None and args.checkpoint_spool is None:
        p.error("--spool_notify needs --checkpoint_spool (nothing to hand over otherwise)")
    if args.trace_export is not None and args.no_tracing:
        # a disabled tracer finishes no trace: the exporter would idle
        p.error("--trace_export needs the span tracer; drop --no_tracing")
    if args.router:
        if not args.replicas:
            p.error("--router needs --replicas URL[,URL...]")
        if args.dalle_path is not None:
            p.error("--router does not load a checkpoint; drop --dalle_path (replicas load their own)")
        if args.checkpoint_spool is not None:
            p.error("--checkpoint_spool needs --engine continuous (the router holds no decode state)")
        return args
    if args.dalle_path is None:
        p.error("--dalle_path is required (unless running --router)")
    if args.replicas is not None:
        p.error("--replicas only applies with --router")
    if args.no_vitals and (args.slo_ttft_ms is not None or args.slo_request_ms is not None):
        # the sampler drives the SLO updates: without it the burn stays 0
        p.error("--slo_ttft_ms/--slo_request_ms need the vitals sampler; drop --no_vitals")
    if not 0.0 < args.slo_objective < 1.0:
        p.error("--slo_objective must be in (0, 1)")
    if args.mesh is not None:
        # at parse time, not after the checkpoint loads
        if args.engine != "continuous":
            p.error("--mesh needs --engine continuous")
        from dalle_pytorch_tpu_torch.serving.sharded import check_served, parse_mesh_shape

        try:
            check_served(parse_mesh_shape(args.mesh))
        except (ValueError, NotImplementedError) as exc:
            p.error(f"bad --mesh {args.mesh!r}: {exc}")
    if args.checkpoint_spool is not None and args.engine != "continuous":
        p.error("--checkpoint_spool needs --engine continuous (the micro engine holds no decode state)")
    if args.spool_every < 1:
        p.error("--spool_every must be >= 1")
    if args.preview_every < 0:
        p.error("--preview_every must be >= 0 (0 turns previews off)")
    if args.request_log_max_mb is not None:
        if args.request_log_path is None:
            p.error("--request_log_max_mb rotates a log file; it needs --request_log_path")
        if args.request_log_max_mb <= 0:
            p.error("--request_log_max_mb must be > 0")
    try:
        args.tenant_weights = parse_tenant_weights(args.tenant_weights) or None
    except ValueError as exc:
        p.error(f"bad --tenant_weights: {exc}")
    if args.tenant_quota_rows is not None and args.tenant_quota_rows < 1:
        p.error("--tenant_quota_rows must be >= 1 (omit it for no quota)")
    if args.replica_quarantine_after < 0:
        p.error("--replica_quarantine_after must be >= 0 (0 turns it off)")
    try:
        args.batch_shapes = tuple(int(b) for b in args.batch_shapes.split(",") if b)
    except ValueError:
        p.error(f"bad --batch_shapes {args.batch_shapes!r}")
    if not args.batch_shapes:
        p.error("--batch_shapes names no batch size")
    if not 0 <= args.reserve_slots < max(args.batch_shapes):
        p.error(f"--reserve_slots must be in [0, {max(args.batch_shapes) - 1}]: every class keeps a slot")
    return args


def run_router(args) -> int:
    """`--router`: the fleet router in front of the replicas; stdlib HTTP
    only, no checkpoint and no torch. One run loop with `python -m
    dalle_pytorch_tpu_torch.serving.router`."""
    from dalle_pytorch_tpu_torch.obs.logging import StructuredLog
    from dalle_pytorch_tpu_torch.serving.router import run_router_server

    log = StructuredLog(component="dalle.router", site=args.trace_site, path=args.request_log_path,
                        max_mb=args.request_log_max_mb)
    return run_router_server(args, log=log)


def build_vitals(args, registry, log):
    """The replica's `EngineVitals`: the sampler, a stall watchdog whose
    queue-head budget is half the request timeout, and the SLO tracker of
    the `--slo_*` targets (off with `--no_vitals`)."""
    from dalle_pytorch_tpu_torch.obs.vitals import EngineVitals, SLOTarget, SLOTracker, StallWatchdog

    targets = []
    if args.slo_ttft_ms is not None:
        targets.append(SLOTarget("ttft", args.slo_ttft_ms / 1000.0, histogram="dalle_serving_ttft_seconds",
                                 objective=args.slo_objective))
    if args.slo_request_ms is not None:
        targets.append(SLOTarget("request", args.slo_request_ms / 1000.0,
                                 histogram="dalle_serving_request_latency_seconds", objective=args.slo_objective))
    return EngineVitals(
        enabled=not args.no_vitals,
        interval_s=args.vitals_interval_s,
        registry=registry,
        log=log,
        watchdog=StallWatchdog(registry=registry, queue_age_budget_s=args.request_timeout_s / 2.0),
        slo=SLOTracker(targets, registry=registry, window_s=args.slo_window_s) if targets else None,
    )


def engine_from_args(args, mesh=None):
    """The replica's engine from its parsed flags (`mesh`: the built device
    mesh of `--mesh`), not warmed up."""
    from dalle_pytorch_tpu_torch.serving.engine import engine_from_checkpoint

    return engine_from_checkpoint(
        args.dalle_path,
        clip_path=args.clip_path,
        batch_shapes=args.batch_shapes,
        cond_scale=args.cond_scale,
        device=args.device,
        mode=args.engine,
        chunk_tokens=args.chunk_tokens,
        prefill_batch=args.prefill_batch,
        kv_dtype=args.kv_dtype,
        decode_sparsity=args.decode_sparsity,
        kv_layout=args.kv_layout,
        page_size=args.page_size,
        kv_pages=args.kv_pages,
        prefix_entries=args.prefix_entries,
        mesh=mesh,
        resume_enabled=not args.no_resume,
        # previews off drops the preview decode from the warmup
        preview_enabled=args.preview_every > 0,
    )


def arm_crash(engine, log) -> None:
    """Restart drills: `DALLE_SERVE_CRASH=program:nth` aborts this replica
    at the nth dispatch of a named program (e.g. `chunk:3`)."""
    spec = os.environ.get("DALLE_SERVE_CRASH")
    if not spec:
        return
    from dalle_pytorch_tpu_torch.serving.faults import FaultInjector

    prog, _, nth = spec.partition(":")
    engine.faults = FaultInjector().crash_nth(prog, int(nth or 1))
    log.event("chaos_crash_armed", program=prog, nth=int(nth or 1))


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    if args.router:
        return run_router(args)
    if args.supervise:
        # before torch: the supervisor only spawns and probes, and the
        # child pays for the runtime (again after each restart)
        from dalle_pytorch_tpu_torch.serving.supervisor import supervise_serve

        return supervise_serve(args, argv)
    from dalle_pytorch_tpu_torch.obs.logging import StructuredLog
    from dalle_pytorch_tpu_torch.obs.profiler import ProfilerCapture
    from dalle_pytorch_tpu_torch.obs.tracing import Tracer
    from dalle_pytorch_tpu_torch.obs.vitals import ProgramCostTable
    from dalle_pytorch_tpu_torch.serving.server import ServingServer
    from dalle_pytorch_tpu_torch.training.metrics import MetricsRegistry
    from dalle_pytorch_tpu_torch.utils import compile_guard

    log = StructuredLog(site=args.trace_site, path=args.request_log_path, max_mb=args.request_log_max_mb)
    registry = MetricsRegistry()
    cache = None
    if args.compile_cache:
        from dalle_pytorch_tpu_torch.utils.compile_cache import CompileCache

        # installed before anything builds: every kernel library of this
        # boot is looked up in the cache first
        cache = CompileCache(args.compile_cache, registry=registry, log=log).install()
    phases = cache.boot_phase if cache is not None else contextlib.nullcontext
    mesh = None
    if args.mesh is not None:  # the devices are counted before the checkpoint loads
        from dalle_pytorch_tpu_torch.serving.engine import resolve_device
        from dalle_pytorch_tpu_torch.serving.sharded import build_serving_mesh

        mesh = build_serving_mesh(args.mesh, device=resolve_device(args.device))
    with phases("checkpoint"):
        engine = engine_from_args(args, mesh)
    engine.registry = registry
    if cache is not None:
        from dalle_pytorch_tpu_torch import kernels
        from dalle_pytorch_tpu_torch.utils.compile_cache import engine_fingerprint

        # any drift of the fingerprint (toolkit, device, sources, config,
        # ladder) turns the artifacts into counted misses
        with phases("plan"):
            cache.bind(engine_fingerprint(engine), kernels.sources())
            cache.plan_boot()
        engine.compile_cache = cache
    if not args.no_program_costs:
        # attached before warmup, which counts each program at its shape
        import torch

        name = torch.cuda.get_device_name(engine.device) if engine.device.type == "cuda" else None
        engine.cost_table = ProgramCostTable(registry=registry, device_name=name)
    if not args.no_warmup:
        log.event("warmup_start", batch_shapes=list(engine.batch_shapes), device=str(engine.device))
        with compile_guard.track_compiles() as tally:
            with phases("warmup"):
                engine.warmup()
        # the warm-boot receipt: against a matching cache, uncached == 0
        log.event(
            "warmup_done", kernel_builds=compile_guard.recent_events(), compiles=tally.count,
            cache_hits=tally.cache_hits, uncached_compiles=tally.uncached,
            boot_cache_mode=cache.plan["mode"] if cache is not None else None,
            boot_seconds=dict(cache.boot_seconds) if cache is not None else None,
        )
    arm_crash(engine, log)
    exporter = None
    if args.trace_export is not None:
        from dalle_pytorch_tpu_torch.obs.aggregate import TraceExporter

        # its drop / sent / retry counters ride the replica's /metrics
        exporter = TraceExporter(args.trace_export, site=args.trace_site, registry=registry)
        log.event("trace_export", url=exporter.url, site=exporter.site)

    server = ServingServer(
        engine,
        host=args.host,
        port=args.port,
        max_delay_ms=args.max_delay_ms,
        max_queue_rows=args.max_queue,
        request_timeout_s=args.request_timeout_s,
        verbose=args.verbose,
        tracer=Tracer(enabled=not args.no_tracing, max_traces=args.trace_ring),
        exporter=exporter,
        log=log,
        log_requests=not args.no_request_log,
        profiler=ProfilerCapture(out_dir=args.profile_dir, device=engine.device),
        trace_dump_path=args.trace_dump,
        vitals=build_vitals(args, registry, log),
        tenant_quota_rows=args.tenant_quota_rows,
        tenant_weights=args.tenant_weights,
        preempt=not args.no_preempt,
        deadline_shed=not args.no_shed,
        reserve_slots=args.reserve_slots,
        quarantine_after=args.replica_quarantine_after,
        checkpoint_spool=args.checkpoint_spool,
        spool_every=args.spool_every,
        preview_every=args.preview_every,
    )
    stopped, stopping = threading.Event(), threading.Event()

    def _shutdown():
        server.shutdown()  # serves the queue, then stops the listener
        stopped.set()

    def _stop(signum, frame):
        if stopping.is_set():  # a second signal: the drain is stuck
            print("[serve] second signal: exiting immediately", flush=True)
            os._exit(1)
        stopping.set()
        print(f"[serve] signal {signum}: draining queue and shutting down", flush=True)
        # shutdown() waits for the serve loop, which runs on this thread
        threading.Thread(target=_shutdown, daemon=True).start()

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)
    # the readiness line orchestrators and tests wait for
    print(
        f"[serve] listening on http://{args.host}:{server.port} (engine={args.engine}, "
        f"device={engine.device}, shapes={engine.batch_shapes}, max_delay_ms={args.max_delay_ms}, "
        f"max_queue={args.max_queue}"
        + ("" if mesh is None else f", mesh={dict(mesh.shape)}") + ")",
        flush=True,
    )
    server.serve_forever()
    stopped.wait(timeout=60)
    print("[serve] shutdown complete", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
