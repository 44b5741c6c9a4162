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
(kernel build, library handles, allocator growth). Vitals, cost tables,
the compile cache and fault injection are not ported yet.

The continuous engine keeps one decode state of `max_batch` cache slots
and advances every live slot by `chunk_tokens` per chunk; the
`ContinuousBatcher` (`serving/batcher.py`) admits prompts into free slots
and retires finished rows at chunk boundaries. Options: an int8 KV cache
(`kv_dtype="int8"`) and policy decode sparsity (`decode_sparsity=
"policy"`, `serving/sparsity.py`). The paged engine keeps K/V in a page
pool with host page tables and a prefix cache (`serving/paging.py`).
Not ported yet: resume and migration, previews, vitals, cost capture,
fault injection, the compile cache, and the sharded engines.
"""

from __future__ import annotations

import copy
import threading
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
    slice_prefix_sidecar,
)
from dalle_pytorch_tpu_torch.models.dvae import DiscreteVAE
from dalle_pytorch_tpu_torch.ops.flash_decode import PAGED_DECODE_IMPL, PAGED_DECODE_IMPLS
from dalle_pytorch_tpu_torch.ops.sampling import keep_count
from dalle_pytorch_tpu_torch.serving.paging import PagedKVManager
from dalle_pytorch_tpu_torch.serving.sparsity import DecodeSparsityPolicy
from dalle_pytorch_tpu_torch.training.pipeline import (
    build_tokenizer,
    dalle_from_config,
    dvae_from_hparams,
    load_clip_checkpoint,
    load_dalle_checkpoint,
)
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
    `top_k` is the FRACTION of the vocabulary to drop (0.9 keeps 10%)."""

    text_ids: np.ndarray  # [text_seq_len] int32
    seed: int = 0
    temperature: float = 1.0
    top_k: float = 0.9


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
        self.model = model.to(self.device).eval()
        self.vae = None if vae is None else vae.to(self.device).eval()
        self.batch_shapes = tuple(sorted(set(int(b) for b in batch_shapes)))
        self.max_batch = self.batch_shapes[-1]
        self.cond_scale = float(cond_scale)
        self.tokenizer = tokenizer
        self.clip = None if clip is None else clip.to(self.device).eval()
        self.cfg = cfg
        self._lock = threading.Lock()  # one generation on the device at a time
        self.stats = EngineStats()

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

        with self._lock:
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
                pixels = (pixels[:n].float() * 0.5 + 0.5).clamp(0.0, 1.0).cpu().numpy()
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
    prefills: int = 0  # rows admitted
    prefill_dispatches: int = 0  # waves
    kv_tiles_read: int = 0  # block-sparse kernel tiles, summed over live rows and layers
    kv_tiles_skipped: int = 0  # tiles the policy skipped that the length skip would read


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
        if kv_dtype is not None and model.kv_dtype is None:
            model = copy.copy(model)
            model.kv_dtype = str(kv_dtype)
        if decode_sparsity == "policy" and model.decode_sparse_block is None:
            model = copy.copy(model)
            model.decode_sparse_block = DECODE_SPARSE_BLOCK
        super().__init__(
            model, vae, batch_shapes=(int(max_batch),), tokenizer=tokenizer, device=device
        )
        self.stats = ContinuousStats()
        self.decode_sparsity = decode_sparsity
        self.chunk_tokens = int(chunk_tokens)
        self.prefill_batch = max(1, min(int(prefill_batch), self.max_batch))
        self._sparsity = (
            DecodeSparsityPolicy(self.model, self.chunk_tokens, self.max_batch)
            if decode_sparsity == "policy" else None
        )
        self._state = self._fresh_state()

    def _fresh_state(self) -> dict:
        return init_slot_state(self.model, self.max_batch)

    def _run(self, op) -> None:
        """Run one state-changing dispatch (caller holds the lock). The
        state is updated in place, so a failure leaves it half-written:
        rebuild a clean one before re-raising (the batcher fails the
        in-flight requests)."""
        try:
            op(self._state)
        except BaseException:
            self._state = self._fresh_state()
            raise

    def _kv_cache_bytes(self) -> int:
        """K/V (+ scale) bytes of the whole cache."""
        return sum(
            leaf.numel() * leaf.element_size()
            for layer in self._state["cache"].values()
            for key, leaf in layer["attn"].items()
            if key in ("k", "v", "k_scale", "v_scale")
        )

    def kv_bytes_per_slot(self) -> int:
        """K/V (+ scale) bytes backing one slot."""
        return self._kv_cache_bytes() // self.max_batch

    def prefill_slots(self, assignments: Sequence[Tuple[int, SampleSpec]], _warmup: bool = False) -> None:
        """Admit up to `prefill_batch` (slot, spec) pairs in one prefill;
        short waves are padded by repeating the first pair."""
        n = len(assignments)
        if not 1 <= n <= self.prefill_batch:
            raise ValueError(
                f"{n} assignments outside [1, prefill_batch={self.prefill_batch}]; "
                "the batcher splits admission waves"
            )
        rows = list(assignments) + [assignments[0]] * (self.prefill_batch - n)
        texts, slots, seeds, temps, keep = _pack_prefill_rows(rows, self._keep_k)
        if texts.shape != (self.prefill_batch, self.model.text_seq_len):
            raise ValueError(
                f"prompt rows must be [{self.model.text_seq_len}] token ids, got batch {texts.shape}"
            )
        bitmap = None if self._sparsity is None else self._sparsity.prefill_bitmaps(self.prefill_batch)
        with self._lock:
            self._run(lambda st: prefill_into_slots(
                self.model, st, texts, slots, seeds, temps, keep, block_bitmap=bitmap
            ))
            if not _warmup:
                self.stats.prefills += n
                self.stats.prefill_dispatches += 1

    def prefill_slot(self, slot: int, spec: SampleSpec, _warmup: bool = False) -> None:
        """Admit one prompt: a one-row `prefill_slots` wave."""
        self.prefill_slots([(slot, spec)], _warmup=_warmup)

    def _pre_chunk(self) -> None:
        """Host work before a chunk's dispatch (caller holds the lock)."""

    def _chunk_op(self, state: dict, bitmap: Optional[np.ndarray]) -> None:
        decode_image_chunk(self.model, state, self.chunk_tokens, block_bitmap=bitmap)

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
            self._run(lambda st: self._chunk_op(st, bitmap))
            if not _warmup:
                self.stats.chunks += 1
                self.stats.batches += 1

    def chunk_snapshot(self) -> Tuple[np.ndarray, np.ndarray]:
        """The chunk-boundary (img_pos, active) host copy: the one designed
        device->host transfer of the decode loop."""
        with self._lock:
            both = torch.cat([self._state["img_pos"], self._state["active"].to(torch.int32)])
            both = both.cpu().numpy()
        return both[: self.max_batch].astype(np.int64), both[self.max_batch :].astype(bool)

    def step_chunk(self, _warmup: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Advance all live slots by `chunk_tokens`; returns the post-chunk
        (img_pos, active) snapshot the batcher retires against."""
        self.dispatch_chunk(_warmup=_warmup)
        return self.chunk_snapshot()

    def snapshot_rows(self, slots: Sequence[int]) -> np.ndarray:
        """Host copy of `slots`' token rows [len(slots), image_seq_len]."""
        with self._lock:
            toks = self._state["img_tokens"].cpu().numpy()
        return toks[list(slots)].astype(np.int32)

    def harvest(self, slots: Sequence[int]) -> np.ndarray:
        """Finished slots' tokens (host copy), counted as generated rows."""
        toks = self.snapshot_rows(slots)
        with self._lock:
            self.stats.rows_generated += len(toks)
        return toks

    def release(self, slots: Sequence[int]) -> None:
        """Deactivate `slots`, after harvest or on an error reset."""
        with self._lock:
            self._run(lambda st: release_slots(st, slots))

    def decode_pixels(self, tokens: np.ndarray) -> Optional[np.ndarray]:
        """Pixels [n, H, W, 3] in [0, 1] of harvested token rows, decoded
        in batches of max_batch (padded), or None without a VAE."""
        if self.vae is None:
            return None
        tokens = np.asarray(tokens, np.int32)
        n = len(tokens)
        pad = (-n) % self.max_batch
        padded = np.concatenate([tokens, np.zeros((pad, tokens.shape[1]), np.int32)])
        outs = []
        with self._lock, torch.inference_mode():
            for i in range(0, len(padded), self.max_batch):
                batch = torch.from_numpy(padded[i : i + self.max_batch]).to(self.device)
                pixels = self.vae.decode(batch).float() * 0.5 + 0.5
                outs.append(pixels.clamp(0.0, 1.0).cpu().numpy())
        return np.concatenate(outs)[:n]

    def warmup(self) -> None:
        """One dummy wave, one chunk, a release and one pixel decode, then a
        fresh state (counted in stats.warmup_batches only)."""
        dummy = SampleSpec(np.zeros(self.model.text_seq_len, np.int32), seed=0)
        self.prefill_slot(0, dummy, _warmup=True)
        self.step_chunk(_warmup=True)
        self.release([0])
        self.decode_pixels(np.zeros((1, self.image_seq_len), np.int32))
        with self._lock:
            self._state = self._fresh_state()
            self.stats.warmup_batches += 1

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
        return init_paged_slot_state(self.model, self.max_batch, self.kv_pages, self.page_size)

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
        """Worst-case page demand of one request's rows."""
        return sum(self.kv.row_demand(self._ids(s)) for s in specs)

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
        if not 1 <= n <= self.prefill_batch:
            raise ValueError(
                f"{n} assignments outside [1, prefill_batch={self.prefill_batch}]; "
                "the batcher splits admission waves"
            )
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
            with self._lock:
                self._run(lambda st: admit_cached_prefix(
                    self.model, st, slot, entry.sidecar, seed, temp, keep, src, dst, self.page_size
                ))
            if not _warmup:
                self.kv.cache.hits += 1
            stats["prefix_hits"] += 1
            stats["hit_slots"].append(slot)
            stats["prefix_blocks_reused"] += self.kv.n_full_blocks
        if not misses:
            return
        rows = list(misses) + [misses[0]] * (self.prefill_batch - len(misses))
        texts, slots, seeds, temps, keep = _pack_prefill_rows(rows, self._keep_k)
        if texts.shape != (self.prefill_batch, self.model.text_seq_len):
            raise ValueError(
                f"prompt rows must be [{self.model.text_seq_len}] token ids, got batch {texts.shape}"
            )
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
            self._run(lambda st: wave.update(sidecar=prefill_into_slots_paged(
                self.model, st, texts, slots, seeds, temps, keep, page_rows, partial_dst,
                self.page_size, block_bitmap=bitmap,
            )))
            if not _warmup:
                self.stats.prefills += len(misses)
                self.stats.prefill_dispatches += 1
        for i, token in pending:
            self.kv.finish_register(token, slice_prefix_sidecar(wave["sidecar"], i))
        if not _warmup:
            self.kv.cache.misses += len(misses)
        stats["dispatches"] += 1

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
            self.model, state, self.chunk_tokens, self.kv.table, block_bitmap=bitmap,
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
        chunk, the releases and one pixel decode, then a fresh state and
        fresh page tables (counted in stats.warmup_batches only)."""
        dummy = SampleSpec(np.zeros(self.model.text_seq_len, np.int32), seed=0)
        self.prefill_slots([(0, dummy)], _warmup=True)
        if self.kv.cache.enabled:
            hit_slot = 1 if self.max_batch > 1 else 0
            if hit_slot == 0:
                self.release([0])
            self.prefill_slots([(hit_slot, dummy)], _warmup=True)
        self.step_chunk(_warmup=True)
        self.release(range(min(2, self.max_batch)))
        self.decode_pixels(np.zeros((1, self.image_seq_len), np.int32))
        with self._lock:
            self._state = self._fresh_state()
            self.stats.warmup_batches += 1


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
):
    """Build a serving engine from a reference single-file DALLE checkpoint
    (with its DiscreteVAE inside), in the checkpoint's dtype (bfloat16 when
    it was trained with bf16).

    `mode="micro"` gives a `GenerationEngine`; `mode="continuous"` a
    `ContinuousEngine` whose slot count is the largest of `batch_shapes`,
    and with `kv_layout="paged"` a `PagedContinuousEngine` (`page_size`,
    `kv_pages`, `prefix_entries` and `paged_decode_impl` as there).
    `kv_dtype="int8"` quantizes the KV cache in either mode (None or
    "model" keeps the model dtype); `decode_sparsity="policy"` needs the
    continuous engine. The tokenizer is the one the checkpoint's config
    names (`build_tokenizer`: its flags, or the default vocabulary), and
    the model's text vocabulary its size: a text embedding of another
    size raises. `clip_path` loads a CLIP checkpoint for `rerank`. The
    engine keeps the config as `cfg`.
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
    if mesh is not None:
        raise NotImplementedError(
            "mesh: the sharded continuous engine is not ported yet (ROADMAP "
            "Queue 1 item 9, serving/sharded.py)"
        )
    dev = resolve_device(device)
    config, dalle_tree, vae_tree, meta = load_dalle_checkpoint(dalle_path)
    if meta.get("vae_class_name") != "DiscreteVAE" or vae_tree is None:
        raise NotImplementedError(
            f"checkpoint VAE {meta.get('vae_class_name')!r}: only a DiscreteVAE "
            "stored in the checkpoint is ported; the pretrained VAE wrappers "
            "are not"
        )
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
        )
        if kv_layout == "paged":
            engine = PagedContinuousEngine(
                model.to(dtype), vae.to(dtype), page_size=page_size, kv_pages=kv_pages,
                prefix_entries=prefix_entries, paged_decode_impl=paged_decode_impl, **common,
            )
        else:
            engine = ContinuousEngine(model.to(dtype), vae.to(dtype), **common)
        engine.clip = None if clip is None else clip.to(dev).eval()
        engine.cfg = config
        return engine
    return GenerationEngine(
        model.to(dtype), vae.to(dtype), batch_shapes=batch_shapes, clip=clip, cfg=config, **common
    )
