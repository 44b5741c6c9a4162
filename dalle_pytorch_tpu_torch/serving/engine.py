"""Serving engines: the micro-batch `GenerationEngine` and the
continuous-batching `ContinuousEngine`, and `engine_from_checkpoint`.

Counterparts of the JAX package's `serving/engine.py` classes of those
names. The micro engine keeps a ladder of batch shapes,
pads every micro-batch up to the nearest rung with copies of row 0 and
slices the padding back off; per-row seed / temperature / top-k ride as
tensors, and a row's sampling noise depends on (seed, image position)
only, so a request gets the same tokens whichever batch it lands in. The
dVAE decode is fused: `generate` returns tokens and pixels in [0, 1].

PyTorch runs eagerly, so there is nothing to compile per shape; `warmup`
runs one dummy batch per rung so the first request pays no one-time cost
(kernel build, library handles, allocator growth). Vitals, cost tables,
the compile cache, fault injection and CLIP rerank are not ported yet.

The continuous engine keeps one decode state of `max_batch` cache slots
and advances every live slot by `chunk_tokens` per chunk; the
`ContinuousBatcher` (`serving/batcher.py`) admits prompts into free slots
and retires finished rows at chunk boundaries. Options: an int8 KV cache
(`kv_dtype="int8"`) and policy decode sparsity (`decode_sparsity=
"policy"`, `serving/sparsity.py`). Not ported yet: resume, previews,
vitals, cost capture, fault injection, the compile cache, and the paged
and sharded engines.
"""

from __future__ import annotations

import copy
import threading
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dalle_pytorch_tpu_torch.data.tokenizer import ByteTokenizer
from dalle_pytorch_tpu_torch.models.attention import DECODE_SPARSE_BLOCK
from dalle_pytorch_tpu_torch.models.dalle import (
    DALLE,
    decode_image_chunk,
    generate_images_cached_batched,
    init_slot_state,
    prefill_into_slots,
    release_slots,
)
from dalle_pytorch_tpu_torch.models.dvae import DiscreteVAE
from dalle_pytorch_tpu_torch.serving.sparsity import DecodeSparsityPolicy
from dalle_pytorch_tpu_torch.training.pipeline import (
    dalle_from_config,
    dvae_from_hparams,
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
    (pixels are decoded in the same call); device: "cuda" unless the
    caller asks for the CPU. The modules are moved to `device`.
    """

    def __init__(
        self,
        model: DALLE,
        vae: Optional[DiscreteVAE] = None,
        batch_shapes: Sequence[int] = (1, 4, 8),
        cond_scale: float = 1.0,
        tokenizer=None,
        device="cuda",
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
        """Fractional drop threshold -> per-row keep count."""
        v = self.model.total_tokens
        frac = min(max(float(top_k), 0.0), 1.0)
        return max(int((1.0 - frac) * v), 1)

    def tokenize(self, prompt: str) -> np.ndarray:
        if self.tokenizer is None:
            raise RuntimeError(
                "engine built without a tokenizer (the port has the byte "
                "tokenizer only; BPE tokenizers are not ported yet)"
            )
        ids = self.tokenizer.tokenize(prompt, self.model.text_seq_len, truncate_text=True)
        return np.asarray(ids[0], dtype=np.int32)

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

    def kv_bytes_per_slot(self) -> int:
        """K/V (+ scale) bytes backing one slot."""
        total = sum(
            leaf.numel() * leaf.element_size()
            for layer in self._state["cache"].values()
            for key, leaf in layer["attn"].items()
            if key in ("k", "v", "k_scale", "v_scale")
        )
        return total // self.max_batch

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

    def dispatch_chunk(self, _warmup: bool = False) -> None:
        """Launch one chunk's device work: every live slot advances by
        `chunk_tokens`. Reads nothing back from the device."""
        with self._lock:
            bitmap = None
            if self._sparsity is not None:
                pos, act = self._state["host"]["img_pos"], self._state["host"]["active"]
                bitmap = self._sparsity.chunk_bitmaps(pos, act)
                if not _warmup:
                    read, skipped = self._sparsity.count_tiles(pos, act)
                    self.stats.kv_tiles_read += read
                    self.stats.kv_tiles_skipped += skipped
            self._run(lambda st: decode_image_chunk(
                self.model, st, self.chunk_tokens, block_bitmap=bitmap
            ))
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
    mesh=None,
):
    """Build a serving engine from a reference single-file DALLE checkpoint
    (with its DiscreteVAE inside), in the checkpoint's dtype (bfloat16 when
    it was trained with bf16).

    `mode="micro"` gives a `GenerationEngine`; `mode="continuous"` a
    `ContinuousEngine` whose slot count is the largest of `batch_shapes`.
    `kv_dtype="int8"` quantizes the KV cache in either mode (None or
    "model" keeps the model dtype); `decode_sparsity="policy"` needs the
    continuous engine. The text vocabulary size comes from the
    checkpoint's text embedding. When it is the byte tokenizer's, the
    engine gets a `ByteTokenizer`; otherwise it has none (the BPE
    tokenizers are not ported) and takes token ids only.
    """
    if mode not in ("micro", "continuous"):
        raise ValueError(f"unknown engine mode {mode!r}")
    if decode_sparsity not in (None, "causal") and mode != "continuous":
        raise ValueError(
            "decode_sparsity='policy' needs the continuous engine (the "
            "micro-batch sampler has no per-slot bitmaps)"
        )
    if kv_layout != "slot":
        raise NotImplementedError(
            f"kv_layout={kv_layout!r}: the paged engine and its kernels are "
            "not ported yet (ROADMAP Queue 1 item 7, Queue 2 items 6 and 8)"
        )
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
    text_rows = dalle_tree["text_emb"]["embedding"].shape[0]
    vocab = text_rows - config["model"]["text_seq_len"]
    model, dtype = dalle_from_config(
        config,
        num_image_tokens=vae.num_tokens,
        image_fmap_size=vae.fmap_size,
        vocab_size=vocab,
    )
    load_dalle_params(model, dalle_tree)
    if kv_dtype not in (None, "model"):
        model.kv_dtype = str(kv_dtype)
    tokenizer = ByteTokenizer() if vocab == ByteTokenizer().vocab_size else None
    common = dict(cond_scale=cond_scale, tokenizer=tokenizer, device=dev)
    if mode == "continuous":
        return ContinuousEngine(
            model.to(dtype),
            vae.to(dtype),
            max_batch=max(int(b) for b in batch_shapes),
            chunk_tokens=chunk_tokens,
            prefill_batch=prefill_batch,
            decode_sparsity=decode_sparsity or "causal",
            **common,
        )
    return GenerationEngine(model.to(dtype), vae.to(dtype), batch_shapes=batch_shapes, **common)
