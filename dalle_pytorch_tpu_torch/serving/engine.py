"""Serving engines: the micro-batch `GenerationEngine`, the
continuous-batching `ContinuousEngine` and its block-paged
`PagedContinuousEngine`, and `engine_from_checkpoint`.

Counterparts of the JAX package's `serving/engine.py` classes of those
names. The micro engine keeps a ladder of batch shapes,
pads every micro-batch up to the nearest rung with copies of row 0 and
slices the padding back off; per-row seed / temperature / top-k ride as
tensors, and a row's sampling noise depends on (seed, image position)
only, so a request gets the same tokens whichever batch it lands in. The
dVAE decode is fused: `generate` returns tokens and pixels in [0, 1].
With a CLIP model, `rerank` orders one prompt's images best-first.

PyTorch runs eagerly, so there is nothing to compile per shape; `warmup`
runs one dummy batch per rung so the first request pays no one-time cost
(kernel build, library handles, allocator growth). Every dispatch calls
`_fault_point(program)` with the reference's program names, a no-op until
a `serving/faults.FaultInjector` is attached as `engine.faults`; an
injected failure takes a real failure's path. Every dispatch also runs
inside a vitals bracket (`_bracket`, the reference's placement): the
dispatch clock of `engine.vitals` (`obs/vitals.py`; the inert
`NULL_VITALS` until an `EngineVitals` binds itself) and, with a
`ProgramCostTable` attached as `engine.cost_table` before `warmup()`, the
program's counted cost at its warmup shape, the kernel launches each
dispatch made, and its measured wall (only walls that end in a host copy,
the chunk boundary's among them, feed MFU). The micro engine's
`generate:<shape>` runs the clock only: it has no cost row.

The continuous engine keeps one decode state of `max_batch` cache slots
and advances every live slot by `chunk_tokens` per chunk; the
`ContinuousBatcher` (`serving/batcher.py`) admits prompts into free slots
and retires finished rows at chunk boundaries. Options: an int8 KV cache
(`kv_dtype="int8"`) and policy decode sparsity (`decode_sparsity=
"policy"`, `serving/sparsity.py`). The paged engine keeps K/V in a page
pool with host page tables and a prefix cache (`serving/paging.py`).
With `resume_enabled`, both continuous engines admit mid-decode rows at
their own position (`resume_slots`, one teacher-forced re-prefill:
decode-state migration, `serving/migrate.py`), and `resume_fingerprint`
names the build a checkpoint must come from; with `preview_enabled`,
`preview_pixels` decodes partial rows for streamed previews
(`serving/streaming.py`). A failed slot dispatch (an injected fault
included: it fires inside the same `try`, before the dispatch touches the
state) leaves a rebuilt, empty state, which the batcher's retry re-admits
into. The continuous engines' tensor-parallel twins over a mesh are in
`serving/sharded.py`; they share these dispatch paths, brackets included.
With a `utils/compile_cache.CompileCache` attached as
`engine.compile_cache` before `warmup()`, warmup ends by exporting the
kernel libraries it made ready into the cache (the export half of the
reference's `_capture_cost`); a failed export is recorded on the cache,
never raised.
"""

from __future__ import annotations

import contextlib
import copy
import threading
import time
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dalle_pytorch_tpu_torch.models.attention import DECODE_SPARSE_BLOCK
from dalle_pytorch_tpu_torch.models.clip import CLIP
from dalle_pytorch_tpu_torch.models.clip import rerank as clip_rerank
from dalle_pytorch_tpu_torch.models.dalle import (
    DALLE,
    admit_cached_prefix,
    decode_image_chunk,
    decode_image_chunk_paged,
    generate_images_cached_batched,
    init_paged_slot_state,
    init_slot_state,
    prefill_into_slots,
    prefill_into_slots_paged,
    release_slots,
    resume_into_slots,
    resume_into_slots_paged,
    shard_states,
    slice_prefix_sidecar,
)
from dalle_pytorch_tpu_torch.models.dvae import DiscreteVAE
from dalle_pytorch_tpu_torch.models.vae_io import decode_unit, is_pretrained, to_unit
from dalle_pytorch_tpu_torch.obs.vitals import NULL_VITALS, kernel_launch_counts, launch_delta
from dalle_pytorch_tpu_torch.ops.flash_decode import PAGED_DECODE_IMPL, PAGED_DECODE_IMPLS
from dalle_pytorch_tpu_torch.ops.sampling import keep_count
from dalle_pytorch_tpu_torch.parallel.tensor_parallel import TensorParallelDALLE
from dalle_pytorch_tpu_torch.serving.paging import PagedKVManager
from dalle_pytorch_tpu_torch.serving.sparsity import DecodeSparsityPolicy
from dalle_pytorch_tpu_torch.training.pipeline import (
    build_tokenizer,
    build_vae,
    dalle_from_config,
    dvae_from_hparams,
    load_clip_checkpoint,
    load_dalle_checkpoint,
)
from dalle_pytorch_tpu_torch.utils.artifact import boot_fingerprint, device_kind
from dalle_pytorch_tpu_torch.utils.flops import DecodeWork, decode_work, forward_cost
from dalle_pytorch_tpu_torch.weights import load_dalle_params, load_dvae_params


def resolve_device(device) -> torch.device:
    """`torch.device(device)`, raising when CUDA is asked for but absent:
    entry points default to the card, and a run without one must say so
    instead of quietly running the plain CPU versions."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False: the port runs on an NVIDIA GPU; pass device='cpu' to "
            "run its plain PyTorch versions on the CPU"
        )
    return dev


@dataclass
class SampleSpec:
    """One batch row: a tokenized prompt plus its sampling parameters.
    `top_k` is the FRACTION of the vocabulary to drop (0.9 keeps 10%).

    `resume_tokens` / `resume_pos` carry a mid-decode prefix (decode-state
    migration): with `resume_pos` > 0 on an engine with `resume_enabled`,
    admission re-prefills the prefix in one teacher-forced dispatch and
    decode continues from `resume_pos`. Other engines ignore them and
    decode from 0, which gives the same tokens ((seed, position)-keyed
    noise) at the cost of the re-decode."""

    text_ids: np.ndarray  # [text_seq_len] int32
    seed: int = 0
    temperature: float = 1.0
    top_k: float = 0.9
    resume_tokens: Optional[np.ndarray] = None  # [resume_pos] int32
    resume_pos: int = 0


@dataclass
class EngineStats:
    batches: int = 0
    rows_generated: int = 0
    rows_padded: int = 0
    warmup_batches: int = 0  # warmup runs count here only


class GenerationEngine:
    """Batched generation over a fixed ladder of batch shapes.

    model: a `DALLE` with its weights; vae: an optional `DiscreteVAE`
    (pixels are decoded in the same call); clip: an optional `CLIP` for
    `rerank`; cfg: the checkpoint's config dict, kept for callers;
    device: "cuda" unless the caller asks for the CPU. The modules are
    moved to `device`.
    """

    def __init__(
        self,
        model: DALLE,
        vae: Optional[DiscreteVAE] = None,
        batch_shapes: Sequence[int] = (1, 4, 8),
        cond_scale: float = 1.0,
        tokenizer=None,
        device="cuda",
        clip: Optional[CLIP] = None,
        cfg: Optional[dict] = None,
    ):
        self.device = resolve_device(device)
        if not batch_shapes or min(int(b) for b in batch_shapes) < 1:
            raise ValueError(f"batch_shapes must be positive sizes, got {batch_shapes}")
        self.model = self._placed_model(model)
        self.vae = None if vae is None else vae.to(self.device).eval()
        self.batch_shapes = tuple(sorted(set(int(b) for b in batch_shapes)))
        self.max_batch = self.batch_shapes[-1]
        self.cond_scale = float(cond_scale)
        self.tokenizer = tokenizer
        self.clip = None if clip is None else clip.to(self.device).eval()
        self.cfg = cfg
        self._lock = threading.Lock()  # one generation on the device at a time
        self.stats = EngineStats()
        #: fault-injection seam (serving/faults.py): None, or a
        #: FaultInjector whose rules fail, stall or crash named dispatches
        self.faults = None
        #: device-telemetry seams (obs/vitals.py), both inert by default:
        #: the dispatch clock the vitals sampler reads, and a
        #: ProgramCostTable that warmup fills (attach it before warmup())
        self.vitals = NULL_VITALS
        self.cost_table = None
        #: the boot's compile cache (utils/compile_cache.py), set before
        #: warmup(); None: nothing exported
        self.compile_cache = None

    def _placed_model(self, model: DALLE) -> DALLE:
        """The model the engine runs: `model` on the engine's device."""
        return model.to(self.device).eval()

    def _fault_point(self, name: str) -> None:
        """Dispatch-site hook of the fault injector (inert without one)."""
        if self.faults is not None:
            self.faults.on_dispatch(name)

    def program_ladder(self) -> Tuple[str, ...]:
        """Names of the dispatch shapes `warmup()` runs: the fixed-shape
        surface the resume fingerprint hashes."""
        return tuple(f"generate:{b}" for b in self.batch_shapes)

    def _export_libraries(self) -> None:
        """Warmup's last step: every kernel library made ready so far that
        the attached compile cache wants goes into it (timed as the boot's
        "export" phase; `export` records a failure, never raises)."""
        cache = self.compile_cache
        if cache is None:
            return
        from dalle_pytorch_tpu_torch import kernels

        with cache.boot_phase("export"):
            for name, info in list(kernels.build_log.items()):
                if name in kernels._libs and cache.wants(name):
                    cache.export(name, info["path"])

    # -------------------------------------------------------------- vitals

    @contextlib.contextmanager
    def _bracket(self, name: str, _warmup: bool = False):
        """The vitals bracket of one dispatch: the dispatch clock the
        sampler reads and, with a cost table attached, the kernel launches
        the dispatch made and (at warmup, on the card) the allocator's
        readings around it. Yields a dict that holds "wall", "launches"
        and "memory" once the dispatch ends."""
        out: dict = {}
        counting = self.cost_table is not None
        counts0 = kernel_launch_counts() if counting else None
        watch_memory = counting and _warmup and self.device.type == "cuda"
        if watch_memory:
            torch.cuda.reset_peak_memory_stats(self.device)
            before = torch.cuda.memory_allocated(self.device)
        t0 = time.perf_counter()
        self.vitals.dispatch_begin(name)
        try:
            yield out
        finally:
            out["wall"] = time.perf_counter() - t0
            self.vitals.dispatch_end(name, out["wall"])
            if counting:
                out["launches"] = launch_delta(counts0, kernel_launch_counts())
            if watch_memory:
                peak = torch.cuda.max_memory_allocated(self.device)
                out["memory"] = {
                    "allocated_before_bytes": int(before),
                    "allocated_after_bytes": int(torch.cuda.memory_allocated(self.device)),
                    "peak_allocated_bytes": int(peak),
                    "temp_size_in_bytes": int(peak - before),
                }

    def _account(self, name: str, dispatch: dict, _warmup: bool, synced: bool, count_fn=None) -> None:
        """Feed one bracketed dispatch to the cost table: at warmup the
        program's counted (FLOPs, bytes) from `count_fn`, with the
        dispatch's launches and memory; afterwards its wall (MFU-grade
        only when `synced`: the wall ends in a host copy) and launches. A
        failed count is recorded on the table, not raised."""
        table = self.cost_table
        if table is None:
            return
        if not _warmup:
            table.record_wall(name, dispatch["wall"], synced=synced, launches=dispatch.get("launches"))
        elif count_fn is not None and not table.has(name):
            try:
                flops, nbytes = count_fn()
            except Exception as exc:
                table.record_error(name, exc)
                return
            table.add(name, flops, nbytes, memory=dispatch.get("memory"), launches=dispatch.get("launches"))

    def resume_fingerprint(self) -> str:
        """The build identity a decode-state checkpoint must match to
        resume here (`serving/migrate.py`): `boot_fingerprint` over torch's
        version, the device kind, the checkpoint config, the program
        ladder and the model's repr (an engine built from a module has no
        config, and two different models must not cross-resume).
        Computed once: a checkpoint from any other build becomes a
        counted clean restart, never a corrupt resume."""
        if getattr(self, "_resume_fingerprint", None) is None:
            self._resume_fingerprint = boot_fingerprint(
                device=device_kind(self.device),
                model_config=self.cfg,
                programs=self.program_ladder(),
                extra={"model": repr(self.model)},
            )
        return self._resume_fingerprint

    def state_dump(self) -> dict:
        """Host-side engine state for stall reports: lock-free reads of
        host counters (a stalled engine holds its lock)."""
        return {
            "engine": type(self).__name__,
            "batch_shapes": list(self.batch_shapes),
            "batches": self.stats.batches,
            "rows_generated": self.stats.rows_generated,
            "warmup_batches": self.stats.warmup_batches,
        }

    def pick_shape(self, n: int) -> int:
        """Smallest rung that fits n rows."""
        if not 1 <= n <= self.max_batch:
            raise ValueError(
                f"batch of {n} rows outside [1, {self.max_batch}] (the engine's "
                "largest shape)"
            )
        return next(b for b in self.batch_shapes if n <= b)

    @property
    def image_seq_len(self) -> int:
        return self.model.image_seq_len

    def _keep_k(self, top_k: float) -> int:
        """Fractional drop threshold (clipped to [0, 1]) -> per-row keep count."""
        return keep_count(min(max(float(top_k), 0.0), 1.0), self.model.total_tokens)

    def tokenize(self, prompt: str) -> np.ndarray:
        if self.tokenizer is None:
            raise RuntimeError("engine built without a tokenizer: it takes token ids only")
        ids = self.tokenizer.tokenize(prompt, self.model.text_seq_len, truncate_text=True)
        return np.asarray(ids[0], dtype=np.int32)

    def rerank(self, prompt: str, images: np.ndarray):
        """Sort one prompt's images [N, H, W, C] in [0, 1] best-first by
        CLIP similarity. Returns (sorted images, scores, order), `order`
        mapping each sorted position to its original row (callers holding
        parallel arrays apply it too); without a CLIP, the images as they
        are, zero scores and the identity order."""
        if self.clip is None:
            return images, np.zeros(len(images), np.float32), np.arange(len(images))
        if self.tokenizer is None:
            raise RuntimeError("reranking needs a tokenizer")
        if images.shape[1] != self.clip.visual_image_size:
            raise ValueError(
                f"CLIP checkpoint expects {self.clip.visual_image_size}px images but "
                f"the VAE decodes {images.shape[1]}px"
            )
        if self.tokenizer.vocab_size > self.clip.num_text_tokens:
            raise ValueError(
                f"tokenizer vocab {self.tokenizer.vocab_size} exceeds CLIP "
                f"num_text_tokens {self.clip.num_text_tokens}"
            )
        ids = self.tokenizer.tokenize(prompt, self.clip.text_seq_len, truncate_text=True)
        text = torch.tensor(ids, dtype=torch.long, device=self.device)
        pixels = torch.tensor(np.asarray(images, np.float32), device=self.device)
        with self._lock:
            _, scores, order = clip_rerank(self.clip, text, pixels, text_mask=text != 0)
            scores, order = scores.float().cpu().numpy(), order.cpu().numpy()
        return images[order], scores, order

    def warmup(self) -> None:
        """Run one dummy batch per rung (counted in stats.warmup_batches)."""
        text_seq = self.model.text_seq_len
        for b in self.batch_shapes:
            dummy = [SampleSpec(np.zeros(text_seq, np.int32), seed=i) for i in range(b)]
            self.generate(dummy, _warmup=True)
        self._export_libraries()

    def generate(self, specs: Sequence[SampleSpec], _warmup: bool = False):
        """Run one micro-batch. Returns (tokens [n, image_seq_len] np.int32,
        pixels [n, H, W, 3] float32 in [0, 1] or None)."""
        n = len(specs)
        shape = self.pick_shape(n)
        pad = shape - n
        rows = list(specs) + [specs[0]] * pad
        text = np.stack([np.asarray(s.text_ids, np.int32) for s in rows])
        if text.shape != (shape, self.model.text_seq_len):
            raise ValueError(
                f"prompt rows must be [{self.model.text_seq_len}] token ids, "
                f"got batch {text.shape}"
            )
        seeds = [int(s.seed) & 0x7FFFFFFF for s in rows]
        temps = torch.tensor([float(s.temperature) for s in rows], dtype=torch.float32)
        keep = torch.tensor([self._keep_k(s.top_k) for s in rows], dtype=torch.int32)

        with self._lock, self._bracket(f"generate:{shape}", _warmup):
            self._fault_point(f"generate:{shape}")
            out = generate_images_cached_batched(
                self.model,
                torch.from_numpy(text).to(self.device),
                seeds, temps, keep,
                cond_scale=self.cond_scale,
                vae=self.vae,
            )
            if self.vae is None:
                toks, pixels = out, None
            else:
                toks, pixels = out
                pixels = to_unit(self.vae, pixels[:n]).cpu().numpy()
            toks = toks[:n].to(torch.int32).cpu().numpy()
            if _warmup:
                self.stats.warmup_batches += 1
            else:
                self.stats.batches += 1
                self.stats.rows_generated += n
                self.stats.rows_padded += pad
        return toks, pixels


def _pack_prefill_rows(rows, keep_k_of):
    """(texts [R, T], slots, seeds, temperatures, keep counts) of (slot,
    SampleSpec) pairs, for one prefill wave."""
    texts = np.stack([np.asarray(spec.text_ids, np.int32) for _, spec in rows])
    slots = [int(s) for s, _ in rows]
    seeds = [int(spec.seed) & 0x7FFFFFFF for _, spec in rows]
    temps = [float(spec.temperature) for _, spec in rows]
    keep = [keep_k_of(spec.top_k) for _, spec in rows]
    return texts, slots, seeds, temps, keep


class SlotAllocator:
    """Host-side allocator of the continuous engine's cache slots, the
    integers [0, n_slots). `alloc` hands out the lowest free slot and
    never aliases; exhaustion returns None. Not thread-safe: the batcher's
    worker is its only caller."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = int(n_slots)
        self._free = sorted(range(self.n_slots), reverse=True)
        self._in_use: set = set()

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        slot = self._free.pop()
        self._in_use.add(slot)
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._in_use:
            raise ValueError(f"slot {slot} is not allocated")
        self._in_use.remove(slot)
        self._free.append(slot)
        self._free.sort(reverse=True)

    @property
    def n_active(self) -> int:
        return len(self._in_use)

    @property
    def n_free(self) -> int:
        return len(self._free)


@dataclass
class ContinuousStats(EngineStats):
    chunks: int = 0
    prefills: int = 0  # rows admitted (resumed rows included)
    prefill_dispatches: int = 0  # waves (resume waves included)
    resume_dispatches: int = 0  # resume waves
    kv_tiles_read: int = 0  # block-sparse kernel tiles, summed over live rows and layers
    kv_tiles_skipped: int = 0  # tiles the policy skipped that the length skip would read


def with_cache_options(model: DALLE, kv_dtype: Optional[str], decode_sparsity: str) -> DALLE:
    """`model`, or a shallow copy sharing its weights, with the continuous
    engine's cache options set: `kv_dtype` (unless the model has one) and,
    under the "policy" decode sparsity, the bitmap block width."""
    if kv_dtype is not None and model.kv_dtype is None:
        model = copy.copy(model)
        model.kv_dtype = str(kv_dtype)
    if decode_sparsity == "policy" and model.decode_sparse_block is None:
        model = copy.copy(model)
        model.decode_sparse_block = DECODE_SPARSE_BLOCK
    return model


class ContinuousEngine(GenerationEngine):
    """Continuous batching: token-boundary admission over cache slots.

    One persistent decode state of `max_batch` slots; `prefill_slots`
    admits up to `prefill_batch` prompts in one prefill (short waves padded
    by repeating a real row), `step_chunk` advances every live slot by
    `chunk_tokens` and returns the chunk-boundary (img_pos, active)
    snapshot, `harvest` / `decode_pixels` / `release` retire finished rows.
    A request's tokens equal the micro engine's for the same seed whether
    it is served alone, padded or admitted mid-flight.

    `kv_dtype="int8"` stores K/V quantized; `decode_sparsity="policy"`
    hands every chunk the `DecodeSparsityPolicy`'s tile bitmaps, so every
    layer runs the block-sparse kernel. Either option makes the engine a
    shallow copy of `model` (sharing its weights) with the attribute set,
    as the reference clones the module. Classifier-free guidance is not
    supported (cond_scale must be 1), as in the reference.

    `resume_enabled` adds `resume_slots` (mid-decode admission, one
    teacher-forced re-prefill of prompt + generated prefix; the resume
    forward carries no policy bitmap, as in the reference) and
    `preview_enabled` the streamed previews' fill + decode
    (`preview_pixels`); each joins the warmup and the program ladder the
    resume fingerprint hashes only when enabled.
    """

    def __init__(
        self,
        model: DALLE,
        vae: Optional[DiscreteVAE] = None,
        max_batch: int = 8,
        chunk_tokens: int = 4,
        prefill_batch: int = 4,
        cond_scale: float = 1.0,
        tokenizer=None,
        kv_dtype: Optional[str] = None,
        decode_sparsity: str = "causal",
        device="cuda",
        resume_enabled: bool = False,
        preview_enabled: bool = False,
    ):
        if float(cond_scale) != 1.0:
            raise ValueError(
                "ContinuousEngine does not support classifier-free guidance "
                "(a per-slot null stream would double the decode); use the "
                "micro-batch GenerationEngine for cond_scale != 1"
            )
        if int(chunk_tokens) < 1:
            raise ValueError(f"chunk_tokens must be >= 1, got {chunk_tokens}")
        if decode_sparsity not in ("causal", "policy"):
            raise ValueError(
                f"unknown decode_sparsity {decode_sparsity!r}: 'causal' (the "
                "dense-causal flash default) or 'policy' (block-sparse flash "
                "from the model's static attention layouts)"
            )
        model = with_cache_options(model, kv_dtype, decode_sparsity)
        super().__init__(
            model, vae, batch_shapes=(int(max_batch),), tokenizer=tokenizer, device=device
        )
        self.stats = ContinuousStats()
        self.resume_enabled = bool(resume_enabled)
        self.preview_enabled = bool(preview_enabled)
        self._preview_fill: Optional[int] = None
        self.decode_sparsity = decode_sparsity
        self.chunk_tokens = int(chunk_tokens)
        self.prefill_batch = max(1, min(int(prefill_batch), self.max_batch))
        self._sparsity = (
            DecodeSparsityPolicy(self.model, self.chunk_tokens, self.max_batch)
            if decode_sparsity == "policy" else None
        )
        if self.tp_model is None:
            self.tp_model = TensorParallelDALLE(self.model)
        self._state = self._fresh_state()

    #: the shards every slot op runs over: the model itself as its one
    #: shard, or the sharded engines' tensor-parallel model
    tp_model: Optional[TensorParallelDALLE] = None

    def _fresh_state(self) -> dict:
        """A clean state {"shards": [one per shard], "host": mirrors}."""
        whole = init_slot_state(self.model, self.max_batch, device=self.tp_model.state_device)
        return self.tp_model.place_state(whole)

    def _run(self, op, fault_tag: str) -> None:
        """Run one state-changing dispatch (caller holds the lock). The
        state is updated in place, so a failure leaves it half-written:
        rebuild a clean one before re-raising (the batcher retries or fails
        the in-flight requests). The fault point `fault_tag` fires first,
        inside the same `try`, so an injected failure rebuilds the state
        as a real one does."""
        try:
            self._fault_point(fault_tag)
            op(self._state)
        except BaseException:
            self._state = self._fresh_state()
            raise

    def _kv_cache_bytes(self) -> int:
        """K/V (+ scale) bytes of the whole cache."""
        return sum(
            leaf.numel() * leaf.element_size()
            for st in self._state["shards"]
            for layer in st["cache"].values()
            for key, leaf in layer["attn"].items()
            if key in ("k", "v", "k_scale", "v_scale")
        )

    def kv_bytes_per_slot(self) -> int:
        """K/V (+ scale) bytes backing one slot."""
        return self._kv_cache_bytes() // self.max_batch

    # ------------------------------------------------------- counted work

    def decode_work(self) -> DecodeWork:
        """The per-forward constants of the cost count
        (`utils/flops.decode_work`), from the model's configuration."""
        if getattr(self, "_decode_work", None) is None:
            m, depth = self.model, self.model.depth
            self._decode_work = decode_work(
                m.dim, depth, m.heads, m.dim_head, m.total_tokens,
                dtype_bytes=torch.empty((), dtype=m.dtype).element_size(), kv_int8=m.kv_dtype == "int8",
                attn_layers=len(set(m.shared_attn_ids or range(depth))),
                ff_layers=len(set(m.shared_ff_ids or range(depth))),
            )
        return self._decode_work

    @property
    def text_positions(self) -> int:
        """Positions of a prompt in the cache: the text and <bos>."""
        return self.model.text_seq_len + 1

    def prefill_cost(self):
        """(FLOPs, bytes) of one prefill dispatch: `prefill_batch` rows of
        the prompt's positions from an empty cache, one logits row each."""
        rows = [(self.text_positions, 0)] * self.prefill_batch
        return forward_cost(self.decode_work(), rows, self.prefill_batch)

    def resume_cost(self):
        """(FLOPs, bytes) of one resume dispatch: `prefill_batch` rows of
        prompt + image_seq_len - 1 positions (the teacher-forced forward's
        fixed length) from an empty cache, one logits row each."""
        rows = [(self.text_positions + self.image_seq_len - 1, 0)] * self.prefill_batch
        return forward_cost(self.decode_work(), rows, self.prefill_batch)

    def chunk_cost(self, img_pos, active):
        """(FLOPs, bytes) of one chunk dispatch from the host mirrors
        `img_pos` / `active` at its start: `chunk_tokens` steps of every
        slot, one position each at cache index text_positions + its image
        position (live rows advance a step, stopping at image_seq_len;
        free slots compute along at their own), one logits row each."""
        seq, work = self.image_seq_len, self.decode_work()
        flops = nbytes = 0.0
        for t in range(self.chunk_tokens):
            pos = [min(int(p) + t, seq) if a else int(p) for p, a in zip(img_pos, active)]
            f, b = forward_cost(work, [(1, self.text_positions + p) for p in pos], len(pos))
            flops, nbytes = flops + f, nbytes + b
        return flops, nbytes

    def _vae_counter(self, name: str, _warmup: bool):
        """A `torch.utils.flop_counter.FlopCounterMode` around the warmup
        dispatch of a dVAE decode program that the cost table has no row
        of yet (it sees the decode's convolutions), else a null context."""
        if not (_warmup and self.cost_table is not None and not self.cost_table.has(name)):
            return contextlib.nullcontext()
        from torch.utils.flop_counter import FlopCounterMode

        return FlopCounterMode(display=False)

    def _vae_cost(self, counter, rows: int):
        """(FLOPs, bytes) of one dVAE decode dispatch of `rows` token rows:
        the counted convolution FLOPs, the decoder's weights, the tokens in
        and the float32 pixels out, each once."""
        params = sum(p.numel() * p.element_size() for p in self.vae.parameters())
        size = self.vae.image_size
        return float(counter.get_total_flops()), float(
            params + rows * self.image_seq_len * 4 + rows * size * size * 3 * 4
        )

    def prefill_slots(self, assignments: Sequence[Tuple[int, SampleSpec]], _warmup: bool = False) -> None:
        """Admit up to `prefill_batch` (slot, spec) pairs in one prefill;
        short waves are padded by repeating the first pair."""
        n = len(assignments)
        _, (texts, slots, seeds, temps, keep) = self._padded_wave(assignments)
        bitmap = None if self._sparsity is None else self._sparsity.prefill_bitmaps(self.prefill_batch)
        with self._lock:
            with self._bracket("prefill", _warmup) as dispatch:
                self._run(lambda st: prefill_into_slots(
                    self.tp_model, st, texts, slots, seeds, temps, keep, block_bitmap=bitmap
                ), "prefill")
            # an asynchronous launch: its wall is host time, never MFU
            self._account("prefill", dispatch, _warmup, synced=False, count_fn=self.prefill_cost)
            if not _warmup:
                self.stats.prefills += n
                self.stats.prefill_dispatches += 1

    def prefill_slot(self, slot: int, spec: SampleSpec, _warmup: bool = False) -> None:
        """Admit one prompt: a one-row `prefill_slots` wave."""
        self.prefill_slots([(slot, spec)], _warmup=_warmup)

    # ------------------------------------------------- mid-decode resume

    @property
    def supports_resume(self) -> bool:
        """True when `resume_slots` may be called (the batcher's gate:
        otherwise rows carrying a resume prefix decode from 0)."""
        return self.resume_enabled

    def _pack_resume_rows(self, rows):
        """(token buffer [R, image_seq_len] with each row's prefix, zeros
        beyond; positions [R]) of one padded wave. A position is clipped
        to [0, image_seq_len - 1] and to the tokens given."""
        img_tokens = np.zeros((len(rows), self.image_seq_len), np.int32)
        img_pos = np.zeros(len(rows), np.int64)
        for r, (_, spec) in enumerate(rows):
            toks = spec.resume_tokens
            if toks is None:
                continue
            toks = np.asarray(toks, np.int32)
            k = min(max(0, int(spec.resume_pos or 0)), self.image_seq_len - 1, len(toks))
            img_tokens[r, :k] = toks[:k]
            img_pos[r] = k
        return img_tokens, img_pos

    def _check_wave(self, assignments) -> None:
        if not 1 <= len(assignments) <= self.prefill_batch:
            raise ValueError(
                f"{len(assignments)} assignments outside [1, prefill_batch="
                f"{self.prefill_batch}]; the batcher splits admission waves"
            )

    def _padded_wave(self, assignments):
        """(rows, packed rows) of one dispatch wave of (slot, spec) pairs,
        padded to `prefill_batch` by repeating the first pair."""
        self._check_wave(assignments)
        rows = list(assignments) + [assignments[0]] * (self.prefill_batch - len(assignments))
        packed = _pack_prefill_rows(rows, self._keep_k)
        if packed[0].shape != (self.prefill_batch, self.model.text_seq_len):
            raise ValueError(
                f"prompt rows must be [{self.model.text_seq_len}] token ids, got batch {packed[0].shape}"
            )
        return rows, packed

    def _resume_rows(self, assignments):
        """The padded wave of a resume: (texts, slots, seeds, temperatures,
        keep counts, token buffer, positions)."""
        if not self.supports_resume:
            raise RuntimeError(
                "resume_slots on an engine built without resume_enabled: the "
                "resume dispatch is not in its warmup or its fingerprint"
            )
        rows, packed = self._padded_wave(assignments)
        return packed + self._pack_resume_rows(rows)

    def _count_resume(self, n: int, _warmup: bool) -> None:
        if not _warmup:
            self.stats.prefills += n
            self.stats.prefill_dispatches += 1
            self.stats.resume_dispatches += 1

    def resume_slots(self, assignments: Sequence[Tuple[int, SampleSpec]], _warmup: bool = False) -> None:
        """Admit up to `prefill_batch` mid-decode rows (specs carrying
        `resume_tokens` / `resume_pos`) in one teacher-forced re-prefill
        (`models/dalle.py:resume_into_slots`): decode continues from each
        row's own position. Short waves are padded as `prefill_slots`'."""
        texts, slots, seeds, temps, keep, img_tokens, img_pos = self._resume_rows(assignments)
        with self._lock:
            with self._bracket("resume", _warmup) as dispatch:
                self._run(lambda st: resume_into_slots(
                    self.tp_model, st, texts, img_tokens, img_pos, slots, seeds, temps, keep
                ), "resume")
            self._account("resume", dispatch, _warmup, synced=False, count_fn=self.resume_cost)
            self._count_resume(len(assignments), _warmup)

    def _pre_chunk(self) -> None:
        """Host work before a chunk's dispatch (caller holds the lock)."""

    def _chunk_op(self, state: dict, bitmap: Optional[np.ndarray]) -> None:
        decode_image_chunk(self.tp_model, state, self.chunk_tokens, block_bitmap=bitmap)

    def dispatch_chunk(self, _warmup: bool = False) -> None:
        """Launch one chunk's device work: every live slot advances by
        `chunk_tokens`. Reads nothing back from the device."""
        with self._lock:
            self._pre_chunk()
            bitmap = None
            if self._sparsity is not None:
                pos, act = self._state["host"]["img_pos"], self._state["host"]["active"]
                bitmap = self._sparsity.chunk_bitmaps(pos, act)
                if not _warmup:
                    read, skipped = self._sparsity.count_tiles(pos, act)
                    self.stats.kv_tiles_read += read
                    self.stats.kv_tiles_skipped += skipped
            self._run(lambda st: self._chunk_op(st, bitmap), "chunk")
            if not _warmup:
                self.stats.chunks += 1
                self.stats.batches += 1

    @property
    def chunk_index(self) -> int:
        """Chunks dispatched outside warmup (a checkpoint records it)."""
        return self.stats.chunks

    def chunk_snapshot(self) -> Tuple[np.ndarray, np.ndarray]:
        """The chunk-boundary (img_pos, active) host copy: the one designed
        device->host transfer of the decode loop."""
        with self._lock:
            state = shard_states(self._state)[0]
            both = torch.cat([state["img_pos"], state["active"].to(torch.int32)])
            both = both.cpu().numpy()
        return both[: self.max_batch].astype(np.int64), both[self.max_batch :].astype(bool)

    def step_chunk(self, _warmup: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Advance all live slots by `chunk_tokens`; returns the post-chunk
        (img_pos, active) snapshot the batcher retires against. The vitals
        bracket spans the launch and the snapshot's host copy, so its wall
        is the chunk's device time (MFU-grade)."""
        host = self._state["host"]
        start = (host["img_pos"].copy(), host["active"].copy()) if _warmup else None
        with self._bracket("chunk", _warmup) as dispatch:
            self.dispatch_chunk(_warmup=_warmup)
            snapshot = self.chunk_snapshot()
        self._account("chunk", dispatch, _warmup, synced=True,
                      count_fn=None if start is None else lambda: self.chunk_cost(*start))
        return snapshot

    def _read_rows(self, slots: Sequence[int], fault: bool) -> np.ndarray:
        """Host copy of `slots`' token rows (the one transfer harvest and
        the preemption snapshot share), under the "harvest" bracket."""
        with self._lock, self._bracket("harvest"):
            if fault:
                self._fault_point("harvest")
            toks = shard_states(self._state)[0]["img_tokens"].cpu().numpy()
        return toks[list(slots)].astype(np.int32)

    def snapshot_rows(self, slots: Sequence[int]) -> np.ndarray:
        """Host copy of `slots`' token rows [len(slots), image_seq_len]."""
        return self._read_rows(slots, fault=False)

    def harvest(self, slots: Sequence[int]) -> np.ndarray:
        """Finished slots' tokens (host copy), counted as generated rows."""
        toks = self._read_rows(slots, fault=True)
        with self._lock:
            self.stats.rows_generated += len(toks)
        return toks

    def release(self, slots: Sequence[int]) -> None:
        """Deactivate `slots`, after harvest or on an error reset."""
        with self._lock, self._bracket("release"):
            self._run(lambda st: release_slots(st, slots), "release")

    def decode_pixels(self, tokens: np.ndarray, _warmup: bool = False) -> Optional[np.ndarray]:
        """Pixels [n, H, W, 3] in [0, 1] of harvested token rows, decoded
        in batches of max_batch (padded), or None without a VAE."""
        self._fault_point("decode_pixels")
        if self.vae is None:
            return None
        tokens = np.asarray(tokens, np.int32)
        n = len(tokens)
        pad = (-n) % self.max_batch
        padded = np.concatenate([tokens, np.zeros((pad, tokens.shape[1]), np.int32)])
        outs = []
        counter = self._vae_counter("decode_pixels", _warmup)
        with self._lock, torch.inference_mode():
            with self._bracket("decode_pixels", _warmup) as dispatch, counter:
                for i in range(0, len(padded), self.max_batch):
                    batch = torch.from_numpy(padded[i : i + self.max_batch]).to(self.device)
                    outs.append(decode_unit(self.vae, batch).cpu().numpy())
            if len(padded) == self.max_batch:  # one decode: the wall is one program's
                self._account("decode_pixels", dispatch, _warmup, synced=True,
                              count_fn=lambda: self._vae_cost(counter, self.max_batch))
        return np.concatenate(outs)[:n]

    # ----------------------------------------------------------- previews

    def preview_fill_token(self) -> int:
        """The codebook index that fills undecoded grid positions of a
        preview: the entry nearest the mean codebook vector (a neutral
        canvas), computed once on the host; 0 without a VAE."""
        if self._preview_fill is None:
            tok = 0
            if self.vae is not None and not is_pretrained(self.vae):
                emb = self.vae.codebook.weight.detach().float().cpu().numpy()
                tok = int(np.argmin(np.linalg.norm(emb - emb.mean(axis=0), axis=-1)))
            self._preview_fill = tok
        return self._preview_fill

    def preview_pixels(
        self, tokens: np.ndarray, positions: np.ndarray, _warmup: bool = False
    ) -> Optional[np.ndarray]:
        """Progressive-preview pixels [n, H, W, 3] in [0, 1] of partial
        token rows (`snapshot_rows`) at per-row decode positions: grid
        positions from a row's position on take `preview_fill_token`, and
        the grid decodes in batches of max_batch (padded), as
        `decode_pixels`; None without a VAE."""
        self._fault_point("preview")
        if self.vae is None:
            return None
        tokens = np.asarray(tokens, np.int32)
        positions = np.asarray(positions, np.int64)
        n = len(tokens)
        pad = (-n) % self.max_batch
        toks = np.concatenate([tokens, np.zeros((pad, tokens.shape[1]), np.int32)])
        pos = np.concatenate([positions, np.zeros(pad, np.int64)])
        fill = self.preview_fill_token()
        outs = []
        counter = self._vae_counter("preview", _warmup)
        with self._lock, torch.inference_mode():
            with self._bracket("preview", _warmup) as dispatch, counter:
                grid = torch.arange(self.image_seq_len, device=self.device)[None, :]
                for i in range(0, len(toks), self.max_batch):
                    t = torch.from_numpy(toks[i : i + self.max_batch]).to(self.device)
                    p = torch.from_numpy(pos[i : i + self.max_batch]).to(self.device)
                    filled = torch.where(grid < p[:, None], t, torch.full_like(t, fill))
                    outs.append(decode_unit(self.vae, filled).cpu().numpy())
            if len(toks) == self.max_batch:
                self._account("preview", dispatch, _warmup, synced=True,
                              count_fn=lambda: self._vae_cost(counter, self.max_batch))
        return np.concatenate(outs)[:n]

    def _warmup_preview(self) -> None:
        if self.preview_enabled and self.vae is not None:
            self.preview_pixels(np.zeros((1, self.image_seq_len), np.int32), np.zeros(1, np.int64), _warmup=True)

    def _warmup_resume(self, slot: int) -> None:
        dummy = SampleSpec(
            np.zeros(self.model.text_seq_len, np.int32), seed=0,
            resume_tokens=np.zeros(1, np.int32), resume_pos=1,
        )
        self.resume_slots([(slot, dummy)], _warmup=True)

    def warmup(self) -> None:
        """One dummy wave, a resume wave (with `resume_enabled`), one chunk,
        the releases, one pixel decode and one preview (with
        `preview_enabled`), then a fresh state (counted in
        stats.warmup_batches only)."""
        dummy = SampleSpec(np.zeros(self.model.text_seq_len, np.int32), seed=0)
        self.prefill_slot(0, dummy, _warmup=True)
        if self.resume_enabled:
            # slot 1 when there is one; a one-slot engine recycles slot 0
            res_slot = 1 if self.max_batch > 1 else 0
            if res_slot == 0:
                self.release([0])
            self._warmup_resume(res_slot)
        self.step_chunk(_warmup=True)
        self.release([s for s in (0, 1) if s < self.max_batch])
        self.decode_pixels(np.zeros((1, self.image_seq_len), np.int32), _warmup=True)
        self._warmup_preview()
        with self._lock:
            self._state = self._fresh_state()
            self.stats.warmup_batches += 1
        self._export_libraries()

    def program_ladder(self) -> Tuple[str, ...]:
        out = ["prefill"] + (["resume"] if self.resume_enabled else []) + ["chunk", "release"]
        if self.vae is not None:
            out.append("decode_pixels")
            if self.preview_enabled:
                out.append("preview")
        return tuple(out)

    def state_dump(self) -> dict:
        out = super().state_dump()
        out.update(
            max_batch=self.max_batch,
            chunk_tokens=self.chunk_tokens,
            prefill_batch=self.prefill_batch,
            chunk_index=self.chunk_index,
            resume_enabled=self.resume_enabled,
            preview_enabled=self.preview_enabled,
        )
        return out

    def sparsity_detail(self) -> Optional[dict]:
        """The policy's summary and tile counters, or None on the causal
        path."""
        if self._sparsity is None:
            return None
        return {
            "mode": "policy",
            **self._sparsity.detail(),
            "kv_tiles_read": self.stats.kv_tiles_read,
            "kv_tiles_skipped": self.stats.kv_tiles_skipped,
        }


class PagedContinuousEngine(ContinuousEngine):
    """Continuous batching over a block-paged KV cache with a prefix cache.

    The slotted engine's serving surface and decode semantics (one chunk
    body, `models/dalle.py:decode_image_chunk`), with K/V in a pool of
    `kv_pages` pages of `page_size` positions and host page tables
    (`serving/paging.py`):

      * device memory follows the tokens held, not `max_batch` worst-case
        lanes: `kv_pages` may be sized below the slotted footprint, and
        admission reserves each row's worst case, so lazy per-chunk page
        allocation never runs dry mid-decode; the batcher keeps a request
        queued while its pages do not fit (`admission_headroom` /
        `admission_demand`) and rejects one that never could
        (`can_ever_admit`);
      * identical caption prefixes share immutable text pages
        (content-hash chains, refcounted, copy-on-write at the
        divergence block), and a full-prompt hit admits with zero
        prefill dispatches from its cached sidecar.

    `paged_decode_impl` picks the chunk's attention over the pool:
    "gather" (contiguous views + the contiguous kernels) or "kernel" (the
    paged kernels); None reads $DALLE_PAGED_DECODE_IMPL (default
    "gather"). Tokens are the slotted engine's bit for bit either way.
    `kv_pages` None sizes the pool for every slot at full length plus the
    garbage page and one row of prefix-cache room.
    """

    def __init__(
        self,
        model: DALLE,
        vae: Optional[DiscreteVAE] = None,
        max_batch: int = 8,
        chunk_tokens: int = 4,
        prefill_batch: int = 4,
        cond_scale: float = 1.0,
        tokenizer=None,
        page_size: int = 32,
        kv_pages: Optional[int] = None,
        prefix_entries: int = 64,
        kv_dtype: Optional[str] = None,
        decode_sparsity: str = "causal",
        paged_decode_impl: Optional[str] = None,
        device="cuda",
        resume_enabled: bool = False,
        preview_enabled: bool = False,
    ):
        self.page_size = int(page_size)
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        pages_per_row = -(-(model.total_seq_len + 1) // self.page_size)
        if kv_pages is None:
            kv_pages = int(max_batch) * pages_per_row + 1 + pages_per_row
        self.kv_pages = int(kv_pages)
        self.prefix_entries = int(prefix_entries)
        impl = PAGED_DECODE_IMPL if paged_decode_impl is None else paged_decode_impl
        if impl not in PAGED_DECODE_IMPLS:
            raise ValueError(f"paged_decode_impl {impl!r} not in {PAGED_DECODE_IMPLS}")
        self.paged_decode_impl = impl
        if self.kv_pages < pages_per_row + 1:
            raise ValueError(
                f"kv_pages={self.kv_pages} cannot hold a single row "
                f"({pages_per_row} pages + the garbage page)"
            )
        super().__init__(
            model, vae, max_batch=max_batch, chunk_tokens=chunk_tokens,
            prefill_batch=prefill_batch, cond_scale=cond_scale, tokenizer=tokenizer,
            kv_dtype=kv_dtype, decode_sparsity=decode_sparsity, device=device,
            resume_enabled=resume_enabled, preview_enabled=preview_enabled,
        )
        if self._sparsity is not None and impl == "kernel" and self._sparsity.block % self.page_size:
            raise ValueError(
                f"the paged kernel reads the policy's {self._sparsity.block}-position "
                f"blocks as whole pages: page_size {self.page_size} must divide it"
            )
        #: the last `prefill_slots` call's admission: {"wave_rows",
        #: "prefix_hits", "hit_slots", "prefix_blocks_reused",
        #: "suffix_tokens_computed", "dispatches"}
        self.last_admission_stats: Optional[dict] = None

    def _fresh_state(self) -> dict:
        """Paged device state and new host page tables, together: after a
        failed dispatch the pools are rebuilt, so every table, refcount
        and cached prefix referring into them goes too."""
        self.kv = PagedKVManager(
            n_rows=self.max_batch,
            page_size=self.page_size,
            max_positions=self.model.total_seq_len + 1,
            text_positions=self.model.text_seq_len + 1,
            n_pages=self.kv_pages,
            max_entries=self.prefix_entries,
        )
        whole = init_paged_slot_state(
            self.model, self.max_batch, self.kv_pages, self.page_size, device=self.tp_model.state_device
        )
        return self.tp_model.place_state(whole)

    # --------------------------------------------------------- admission

    @staticmethod
    def _ids(spec: SampleSpec) -> np.ndarray:
        return np.asarray(spec.text_ids, np.int32)

    def can_admit(self, specs: Sequence[SampleSpec]) -> bool:
        """Free + evictable pages cover these rows' worst case on top of
        live rows' reservations."""
        return self.kv.can_admit([self._ids(s) for s in specs])

    def admission_headroom(self) -> int:
        """Pages available for new admissions (the batcher snapshots it
        once per wave and debits `admission_demand` per request)."""
        return self.kv.admission_headroom()

    def admission_demand(self, specs: Sequence[SampleSpec]) -> int:
        """Worst-case page demand of one request's rows. A resume row is
        charged a full row even when its prompt is prefix-cached:
        `admit_resume` gives it fresh pages (the resume dispatch rewrites
        every page it maps with the row's own K/V)."""
        return sum(
            self.kv.pages_per_row if self.supports_resume and s.resume_pos
            else self.kv.row_demand(self._ids(s))
            for s in specs
        )

    def can_ever_admit(self, specs: Sequence[SampleSpec]) -> bool:
        """False when the request could not fit an empty pool."""
        return self.kv.can_ever_admit(len(specs))

    def protect_admission_wave(self, assignments) -> set:
        """Pin the prefix entries of a wave's full-prompt hits against
        eviction until `unprotect_admission_wave`: the batcher budgets a
        whole wave against one headroom snapshot but dispatches it in
        `prefill_batch` splits, and an earlier split evicting an entry a
        later split was budgeted against would overdraw the reservation.
        Returns the keys it added (pass them back verbatim)."""
        if not self.kv.cache.enabled:
            return set()
        entries = (self.kv.cache.peek_full(self._ids(spec)) for _, spec in assignments)
        return self.kv.cache.protect(e.key for e in entries if e is not None)

    def unprotect_admission_wave(self, keys) -> None:
        self.kv.cache.unprotect(keys)

    # --------------------------------------------------------- accounting

    def kv_page_bytes(self) -> int:
        """Bytes of one page across all layers (K + V + int8 scales)."""
        return self._kv_cache_bytes() // self.kv_pages

    def kv_bytes_per_slot(self) -> int:
        """Worst-case bytes one row can pin: its full page complement."""
        return self.kv_page_bytes() * self.kv.pages_per_row

    def kv_detail(self) -> dict:
        """Block-pool and prefix-cache snapshot."""
        cache = self.kv.cache
        return {
            "layout": "paged",
            "paged_decode_impl": self.paged_decode_impl,
            "page_size": self.page_size,
            "pages_per_row": self.kv.pages_per_row,
            "dtype": str(self.model.kv_dtype or self.model.dtype),
            "bytes_per_page": self.kv_page_bytes(),
            "blocks_total": self.kv.pool.n_pages - 1,
            "blocks_active": self.kv.blocks_active,
            "blocks_free": self.kv.blocks_free,
            "prefix_cache": {
                "entries": len(cache),
                "hits": cache.hits,
                "misses": cache.misses,
                "evictions": cache.evictions,
            },
        }

    # ----------------------------------------------------------- slot ops

    def prefill_slots(self, assignments: Sequence[Tuple[int, SampleSpec]], _warmup: bool = False) -> None:
        """Paged admission of up to `prefill_batch` (slot, spec) pairs:
        full-prompt prefix hits admit from their cached sidecar (no
        prefill dispatch), before the misses, which run one batched
        prefill that maps cached prefix blocks into their tables instead
        of allocating and registers fresh prompts in the cache."""
        n = len(assignments)
        self._check_wave(assignments)
        stats = {
            "wave_rows": n, "prefix_hits": 0, "hit_slots": [],
            "prefix_blocks_reused": 0, "suffix_tokens_computed": 0, "dispatches": 0,
        }
        hits, misses = [], []
        for slot, spec in assignments:
            entry = self.kv.cache.lookup_full(self._ids(spec)) if self.kv.cache.enabled else None
            if entry is not None:
                hits.append((slot, spec, entry))
            else:
                misses.append((slot, spec))
        # hit entries stay pinned for the whole wave (see
        # protect_admission_wave); this pin covers direct callers
        added = self.kv.cache.protect(entry.key for _, _, entry in hits)
        kv = self.kv
        try:
            self._admit_wave(hits, misses, stats, _warmup)
        finally:
            kv.cache.unprotect(added)
        self.last_admission_stats = stats

    def _admit_wave(self, hits, misses, stats, _warmup) -> None:
        for slot, spec, entry in hits:
            if self.kv.cache.lookup_full(self._ids(spec)) is not entry:
                misses.append((slot, spec))  # evicted mid-wave: a full prefill
                continue
            src, dst = self.kv.admit_hit(slot, entry)
            seed, temp, keep = int(spec.seed) & 0x7FFFFFFF, float(spec.temperature), self._keep_k(spec.top_k)
            with self._lock, self._bracket("admit_hit", _warmup):
                self._run(lambda st: admit_cached_prefix(
                    self.tp_model, st, slot, entry.sidecar, seed, temp, keep, src, dst, self.page_size
                ), "admit_hit")
            if not _warmup:
                self.kv.cache.hits += 1
            stats["prefix_hits"] += 1
            stats["hit_slots"].append(slot)
            stats["prefix_blocks_reused"] += self.kv.n_full_blocks
        if not misses:
            return
        _, (texts, slots, seeds, temps, keep) = self._padded_wave(misses)
        page_rows = np.zeros((self.prefill_batch, self.kv.n_text_pages), np.int32)
        partial_dst = np.zeros(self.prefill_batch, np.int32)
        pending = []  # (prefill row, registration token)
        registered = set()  # one prompt twice in a wave registers once
        # wave-local {chain hash: page}: later rows map earlier rows' pages
        # for identical leading blocks
        wave_blocks: dict = {}
        text_positions = self.model.text_seq_len + 1
        for i, (slot, spec) in enumerate(misses):
            ids = self._ids(spec)
            page_row, pdst, shared, token = self.kv.admit_miss(
                slot, ids, register=ids.tobytes() not in registered, pending_blocks=wave_blocks
            )
            registered.add(ids.tobytes())
            page_rows[i], partial_dst[i] = page_row, pdst
            if token is not None:
                pending.append((i, token))
            stats["prefix_blocks_reused"] += shared
            stats["suffix_tokens_computed"] += text_positions - shared * self.page_size
        # padding rows rewrite row 0's pages with the same bytes; their
        # snapshot write goes to the garbage page
        page_rows[len(misses):] = page_rows[0]
        bitmap = None if self._sparsity is None else self._sparsity.prefill_bitmaps(self.prefill_batch)
        wave = {}
        with self._lock:
            with self._bracket("prefill", _warmup) as dispatch:
                self._run(lambda st: wave.update(sidecar=prefill_into_slots_paged(
                    self.tp_model, st, texts, slots, seeds, temps, keep, page_rows, partial_dst,
                    self.page_size, block_bitmap=bitmap,
                )), "prefill")
            self._account("prefill", dispatch, _warmup, synced=False, count_fn=self.prefill_cost)
            if not _warmup:
                self.stats.prefills += len(misses)
                self.stats.prefill_dispatches += 1
        for i, token in pending:
            self.kv.finish_register(token, slice_prefix_sidecar(wave["sidecar"], i))
        if not _warmup:
            self.kv.cache.misses += len(misses)
        stats["dispatches"] += 1

    def resume_slots(self, assignments: Sequence[Tuple[int, SampleSpec]], _warmup: bool = False) -> None:
        """Paged mid-decode admission: fresh pages cover each row's prompt
        + generated prefix (`PagedKVManager.admit_resume`, no prefix
        sharing), then one teacher-forced `resume_into_slots_paged`
        writes them; blocks beyond the prefix stay on the garbage page
        until `ensure` maps them ahead of decode."""
        texts, slots, seeds, temps, keep, img_tokens, img_pos = self._resume_rows(assignments)
        page_rows = np.zeros((self.prefill_batch, self.kv.pages_per_row), np.int32)
        mapped: dict = {}  # slot -> its row of page_rows (padding repeats a real pair)
        text_positions = self.model.text_seq_len + 1
        for r, slot in enumerate(slots):
            if slot not in mapped:
                self.kv.admit_resume(slot, text_positions + int(img_pos[r]))
                mapped[slot] = self.kv.table[slot].copy()
            page_rows[r] = mapped[slot]
        with self._lock:
            # a failure rebuilds the state and (`_fresh_state`) the page
            # tables, discarding these mappings
            with self._bracket("resume", _warmup) as dispatch:
                self._run(lambda st: resume_into_slots_paged(
                    self.tp_model, st, texts, img_tokens, img_pos, slots, seeds, temps, keep,
                    page_rows, self.page_size,
                ), "resume")
            self._account("resume", dispatch, _warmup, synced=False, count_fn=self.resume_cost)
            self._count_resume(len(assignments), _warmup)

    def _pre_chunk(self) -> None:
        # lazy decode-page allocation: every live row's table covers its
        # writes of this chunk (reserved at admission: cannot fail)
        host = self._state["host"]
        text_positions = self.model.text_seq_len + 1
        for slot in np.flatnonzero(host["active"]):
            end = min(
                text_positions + int(host["img_pos"][slot]) + self.chunk_tokens,
                self.kv.max_positions,
            )
            self.kv.ensure(int(slot), -(-end // self.page_size))

    def _chunk_op(self, state: dict, bitmap: Optional[np.ndarray]) -> None:
        decode_image_chunk_paged(
            self.tp_model, state, self.chunk_tokens, self.kv.table, block_bitmap=bitmap,
            paged_impl=self.paged_decode_impl,
        )

    def release(self, slots: Sequence[int]) -> None:
        """Deactivate `slots` and return the pages of those that were live
        (a free slot holds none)."""
        slots = [int(s) for s in slots]
        with self._lock:
            was_active = [s for s in slots if self._state["host"]["active"][s]]
        super().release(slots)
        for s in was_active:
            self.kv.release(s)

    def warmup(self) -> None:
        """A miss wave, a deliberate full-prompt hit of the same prompt, a
        resume wave (with `resume_enabled`), a chunk, the releases, one
        pixel decode and one preview (with `preview_enabled`), then a
        fresh state and fresh page tables (counted in
        stats.warmup_batches only)."""
        dummy = SampleSpec(np.zeros(self.model.text_seq_len, np.int32), seed=0)
        self.prefill_slots([(0, dummy)], _warmup=True)
        if self.kv.cache.enabled:
            hit_slot = 1 if self.max_batch > 1 else 0
            if hit_slot == 0:
                self.release([0])
            self.prefill_slots([(hit_slot, dummy)], _warmup=True)
        if self.resume_enabled:
            # the next free slot; small engines recycle slot 0
            res_slot = 2 if self.max_batch > 2 else 0
            if res_slot == 0:
                self.release([0])
            self._warmup_resume(res_slot)
        self.step_chunk(_warmup=True)
        self.release(range(min(3, self.max_batch)))
        self.decode_pixels(np.zeros((1, self.image_seq_len), np.int32), _warmup=True)
        self._warmup_preview()
        with self._lock:
            self._state = self._fresh_state()
            self.stats.warmup_batches += 1
        self._export_libraries()

    def program_ladder(self) -> Tuple[str, ...]:
        out = list(super().program_ladder())
        if self.kv.cache.enabled:
            out.insert(1, "admit_hit")
        return tuple(out)

    def state_dump(self) -> dict:
        out = super().state_dump()
        out["kv"] = self.kv.debug_dump()
        return out


def engine_from_checkpoint(
    dalle_path: str,
    batch_shapes: Sequence[int] = (1, 4, 8),
    cond_scale: float = 1.0,
    device="cuda",
    mode: str = "micro",
    chunk_tokens: int = 4,
    prefill_batch: int = 4,
    kv_dtype: Optional[str] = None,
    decode_sparsity: Optional[str] = None,
    kv_layout: str = "slot",
    page_size: int = 32,
    kv_pages: Optional[int] = None,
    prefix_entries: int = 64,
    paged_decode_impl: Optional[str] = None,
    mesh=None,
    clip_path: Optional[str] = None,
    resume_enabled: Optional[bool] = None,
    preview_enabled: Optional[bool] = None,
):
    """Build a serving engine from a reference single-file DALLE checkpoint
    (with its DiscreteVAE inside, or, for a model trained with a pretrained
    wrapper, the wrapper rebuilt from the config's paths by `build_vae`),
    in the checkpoint's dtype (bfloat16 when it was trained with bf16).

    `mode="micro"` gives a `GenerationEngine`; `mode="continuous"` a
    `ContinuousEngine` whose slot count is the largest of `batch_shapes`,
    and with `kv_layout="paged"` a `PagedContinuousEngine` (`page_size`,
    `kv_pages`, `prefix_entries` and `paged_decode_impl` as there). `mesh`
    (a `serving/sharded.py:parse_mesh_shape` string, a dict or a built
    `DeviceMesh`) picks the continuous engine's tensor-parallel twin,
    `ShardedContinuousEngine` or `ShardedPagedContinuousEngine`, the
    mesh built over the visible devices of `device`'s type; the model is
    then cut into its shards from the host and never whole on a card.
    `kv_dtype="int8"` quantizes the KV cache in either mode (None or
    "model" keeps the model dtype); `decode_sparsity="policy"` needs the
    continuous engine. The tokenizer is the one the checkpoint's config
    names (`build_tokenizer`: its flags, or the default vocabulary), and
    the model's text vocabulary its size: a text embedding of another
    size raises. `clip_path` loads a CLIP checkpoint for `rerank`. The
    engine keeps the config as `cfg`. A continuous engine serves
    mid-decode resumes and previews unless `resume_enabled` /
    `preview_enabled` is False (None means on, as the reference's serving
    boots).
    """
    if mode not in ("micro", "continuous"):
        raise ValueError(f"unknown engine mode {mode!r}")
    if decode_sparsity not in (None, "causal") and mode != "continuous":
        raise ValueError(
            "decode_sparsity='policy' needs the continuous engine (the "
            "micro-batch sampler has no per-slot bitmaps)"
        )
    if kv_layout not in ("slot", "paged"):
        raise ValueError(f"unknown kv_layout {kv_layout!r} ('slot' or 'paged')")
    if kv_layout == "paged" and mode != "continuous":
        raise ValueError("kv_layout='paged' needs the continuous engine (mode='continuous')")
    if mesh is not None and mode != "continuous":
        raise ValueError("mesh needs the continuous engine (mode='continuous')")
    dev = resolve_device(device)
    if mesh is not None:
        from dalle_pytorch_tpu_torch.serving import sharded

        if isinstance(mesh, (str, dict)):
            shape = sharded.parse_mesh_shape(mesh) if isinstance(mesh, str) else dict(mesh)
            sharded.check_served(shape)  # before the checkpoint loads
            mesh = sharded.build_serving_mesh(shape, device=dev)
    config, dalle_tree, vae_tree, meta, _ = load_dalle_checkpoint(dalle_path, opt=False)
    if vae_tree is None:
        # trained with a pretrained wrapper: rebuilt from the config's paths
        vae = build_vae(config)
    elif meta.get("vae_class_name") != "DiscreteVAE" or not meta.get("vae_hparams"):
        raise ValueError(
            f"{dalle_path}: VAE weights of class {meta.get('vae_class_name')!r} without "
            "DiscreteVAE hyperparameters"
        )
    else:
        vae = load_dvae_params(dvae_from_hparams(meta["vae_hparams"]), vae_tree)
    tokenizer = build_tokenizer(config)
    vocab = max(tokenizer.vocab_size, 1)
    text_rows = dalle_tree["text_emb"]["embedding"].shape[0]
    text_seq_len = config["model"]["text_seq_len"]
    if text_rows != vocab + text_seq_len:
        raise ValueError(
            f"{dalle_path}: the text embedding has {text_rows} rows, but the config's "
            f"tokenizer ({type(tokenizer).__name__}, vocabulary {vocab}) and text_seq_len "
            f"{text_seq_len} need {vocab + text_seq_len}: the checkpoint was trained with "
            "another vocabulary than its config names (bpe_path / hug / chinese / yttm / "
            "native, or the default vocabulary when none is set)"
        )
    model, dtype = dalle_from_config(
        config,
        num_image_tokens=vae.num_tokens,
        image_fmap_size=vae.fmap_size,
        vocab_size=vocab,
    )
    load_dalle_params(model, dalle_tree)
    if kv_dtype not in (None, "model"):
        model.kv_dtype = str(kv_dtype)
    clip = None if clip_path is None else load_clip_checkpoint(clip_path)
    common = dict(cond_scale=cond_scale, tokenizer=tokenizer, device=dev)
    if mode == "continuous":
        common.update(
            max_batch=max(int(b) for b in batch_shapes),
            chunk_tokens=chunk_tokens,
            prefill_batch=prefill_batch,
            decode_sparsity=decode_sparsity or "causal",
            resume_enabled=True if resume_enabled is None else bool(resume_enabled),
            preview_enabled=True if preview_enabled is None else bool(preview_enabled),
        )
        paged = kv_layout == "paged"
        if mesh is not None:
            cls = sharded.ShardedPagedContinuousEngine if paged else sharded.ShardedContinuousEngine
            common["mesh"] = mesh
        else:
            cls = PagedContinuousEngine if paged else ContinuousEngine
        if paged:
            common.update(page_size=page_size, kv_pages=kv_pages, prefix_entries=prefix_entries,
                          paged_decode_impl=paged_decode_impl)
        engine = cls(model.to(dtype), vae.to(dtype), **common)
        engine.clip = None if clip is None else clip.to(dev).eval()
        engine.cfg = config
        return engine
    return GenerationEngine(
        model.to(dtype), vae.to(dtype), batch_shapes=batch_shapes, clip=clip, cfg=config, **common
    )
