"""Tensor-parallel serving: one continuous engine over a mesh of devices,
the counterpart of the JAX package's `serving/sharded.py`
(`parse_mesh_shape`, `build_serving_mesh`, `_MeshServingMixin`,
`ShardedContinuousEngine`, `ShardedPagedContinuousEngine`).

A model or a slot cache too large for one card serves from one engine
spread over the devices of the mesh's model axis (`tp`):

  * the DALLE's parameters are cut by `parallel/partition.py`'s rules
    into shard modules (`parallel/tensor_parallel.py:TensorParallelDALLE`:
    heads, FF hidden units and vocabularies split, the rest whole), and
    the VAE stays whole on shard 0, where the pixel decode runs;
  * the decode state is placed by `parallel/serving_partition.py`: each
    shard holds its heads of the K/V cache (the slot lanes or the paged
    pool; pages never split), its columns of the pending logits and a copy
    of the per-row scalars and shift rings; the host mirrors, the page
    tables, refcounts and the prefix index stay one host copy;
  * the slot ops of `models/dalle.py` (prefill, chunk, resume, release,
    the paged prefill and the cached-prefix admit) are the unsharded
    engine's, run over the shards (every continuous engine holds a
    `TensorParallelDALLE`; the unsharded one's single shard is its model),
    the attention of each shard through the head-split kernel wrappers
    (`ops/flash_decode.py:sharded_flash_decode_attention`,
    `sharded_paged_decode_attention`).

One process drives every shard, in order, on each device's current
stream; copies between shards are `Tensor.to`, so one card may be named
twice in `devices=` (every kernel then runs at the split head count on
that card). The `prefill_slots` / `step_chunk` / `harvest` / `release` /
`resume_slots` seam keeps its signatures, so the batcher, the server and
the migration codec run unchanged; `serve.py --mesh tp=N` is the switch.

Contract: at tp = 1 tokens and logits are the unsharded engine's bits. At
tp > 1 the row-parallel sums round differently from one whole product, so
logits agree within a tolerance (the JAX package pins bit-identical tokens
across its mesh, which GSPMD's reductions allow and the port's do not).
Only `tp` is served: `dp`, `fsdp` and `sp` above 1 raise
NotImplementedError (ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.parallel.mesh import MESH_AXES, DeviceMesh, make_mesh, visible_devices
from dalle_pytorch_tpu_torch.parallel.serving_partition import SERVING_MODEL_AXIS, state_bytes
from dalle_pytorch_tpu_torch.parallel.tensor_parallel import TensorParallelDALLE
from dalle_pytorch_tpu_torch.serving.engine import (
    ContinuousEngine,
    PagedContinuousEngine,
    resolve_device,
    with_cache_options,
)

#: where the axes a served mesh may not use yet are queued
UNSERVED_ITEM = "ROADMAP.md Queue 1 item 8"


def parse_mesh_shape(spec: Union[str, None]) -> dict:
    """`--mesh dp=1,tp=4`-style flag -> {axis: size}. Axes are `MESH_AXES`;
    omitted axes have size 1; at most one size may be -1 (the remaining
    devices). Empty or None puts every device on the model axis
    ({"tp": -1})."""
    if not spec:
        return {"tp": -1}
    out: dict = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"mesh axis {part!r} must be axis=size (e.g. dp=1,tp=4)")
        key, value = (t.strip() for t in part.split("=", 1))
        if key not in MESH_AXES:
            raise ValueError(f"unknown mesh axis {key!r}; use one of {MESH_AXES}")
        size = int(value)
        if size != -1 and size < 1:
            raise ValueError(f"mesh axis {key}={size}: sizes must be >= 1 (or -1 to absorb the "
                             "remaining devices)")
        out[key] = size
    return out


def check_served(shape: dict) -> None:
    """Raise NotImplementedError for a mesh with `dp`, `fsdp` or `sp` above
    1: the sharded engines serve the model axis only."""
    extra = {k: v for k, v in shape.items() if k != SERVING_MODEL_AXIS and v != 1}
    if extra:
        raise NotImplementedError(
            f"mesh axes {extra}: the sharded engines serve tensor parallelism (tp) only; "
            f"dp, fsdp and sp above 1 are {UNSERVED_ITEM}"
        )


def build_serving_mesh(shape: Union[str, dict, None] = None, devices=None, device="cuda") -> DeviceMesh:
    """Resolve a mesh request against the devices (default: every visible
    device of `device`'s type) and build the 4-axis mesh. A -1 size absorbs
    the remaining devices; a product smaller than the device count takes
    the first devices; a larger one raises."""
    shape = dict(parse_mesh_shape(shape) if shape is None or isinstance(shape, str) else shape)
    for k, v in shape.items():
        if k not in MESH_AXES:
            raise ValueError(f"unknown mesh axis {k!r}; use one of {MESH_AXES}")
        if v != -1 and v < 1:
            raise ValueError(f"mesh axis {k}={v}: sizes must be >= 1")
    devices = list(devices) if devices is not None else visible_devices(device)
    n = len(devices)
    neg = [k for k, v in shape.items() if v == -1]
    if len(neg) > 1:
        raise ValueError(f"at most one mesh axis may be -1, got {shape}")
    fixed = 1
    for v in shape.values():
        if v != -1:
            fixed *= v
    if neg:
        if n % fixed:
            raise ValueError(f"{n} devices not divisible by the fixed axes {fixed}")
        shape[neg[0]] = n // fixed
        fixed = n
    if fixed > n:
        raise ValueError(f"mesh {shape} needs {fixed} devices, have {n}")
    return make_mesh(devices=devices[:fixed], **{a: shape.get(a, 1) for a in MESH_AXES})


class _MeshServingMixin:
    """What the slotted and paged sharded engines share: the mesh and the
    shard modules (the base engines run their slot ops over them and place
    their state by them) and the per-shard observability block."""

    #: the axis heads and vocabularies split over (the placement rules')
    model_axis = SERVING_MODEL_AXIS

    def _init_mesh(self, model: DALLE, mesh, device, kv_dtype, decode_sparsity):
        """Resolve the mesh and build the shard modules from `model` (left
        where it is) with the engine's cache options. Returns (a weightless
        copy of the model on the meta device, for the engine's
        configuration; shard 0's device)."""
        dev = resolve_device(device)
        if mesh is None or isinstance(mesh, (str, dict)):
            mesh = build_serving_mesh(mesh, device=dev)
        check_served(mesh.shape)
        devices = mesh.axis_devices(self.model_axis)
        if any(torch.device(d).type != dev.type for d in devices):
            raise ValueError(f"mesh devices {[str(d) for d in devices]} are not {dev.type} devices")
        self.mesh = mesh
        model = with_cache_options(model, kv_dtype, decode_sparsity)
        self.tp_model = TensorParallelDALLE(model, mesh, self.model_axis)
        with torch.device("meta"):
            config = DALLE(**{**model.init_kwargs, "kv_dtype": model.kv_dtype,
                              "decode_sparse_block": model.decode_sparse_block})
        return config.to(model.dtype), torch.device(devices[0])

    def _placed_model(self, model: DALLE) -> DALLE:
        return model.eval()  # the configuration: the weights live in the shards

    # ------------------------------------------------------ observability

    def mesh_detail(self) -> dict:
        """Mesh geometry and each shard's bytes (its state and its
        parameters) for `/healthz` and `state_dump()`, keyed by shard and
        device ("tp0:cuda:0"): two shards may share a card. Host-side
        reads of tensor sizes only."""
        per: dict = {}
        states = self._state["shards"]
        for s, (dev, module, state) in enumerate(zip(self.tp_model.devices, self.tp_model.shards, states)):
            params = sum(p.numel() * p.element_size() for p in module.parameters())
            per[f"{self.model_axis}{s}:{dev}"] = params + state_bytes(state)
        return {
            "axes": dict(self.mesh.shape),
            "devices": self.mesh.size,
            "model_axis": self.model_axis,
            "per_device_state_bytes": per,
        }

    def state_dump(self) -> dict:
        out = super().state_dump()
        out["mesh"] = self.mesh_detail()
        return out


class ShardedContinuousEngine(_MeshServingMixin, ContinuousEngine):
    """`ContinuousEngine` with its parameters and slot cache split over
    the `tp` axis of a mesh. `mesh` is a `DeviceMesh`, or a
    `parse_mesh_shape` string or dict (None: every visible device of
    `device`'s type on `tp`) built over the visible devices. Everything
    else as the base."""

    def __init__(
        self,
        model: DALLE,
        vae=None,
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
        mesh=None,
    ):
        config, dev = self._init_mesh(model, mesh, device, kv_dtype, decode_sparsity)
        super().__init__(
            config, vae, max_batch=max_batch, chunk_tokens=chunk_tokens, prefill_batch=prefill_batch,
            cond_scale=cond_scale, tokenizer=tokenizer, kv_dtype=kv_dtype,
            decode_sparsity=decode_sparsity, device=dev, resume_enabled=resume_enabled,
            preview_enabled=preview_enabled,
        )


class ShardedPagedContinuousEngine(_MeshServingMixin, PagedContinuousEngine):
    """`PagedContinuousEngine` over a mesh: each shard's page pool holds its
    heads of every page; the page tables, refcounts and prefix index stay
    one host copy, and admission and eviction run unchanged. A prefix
    entry's sidecar is one per shard."""

    def __init__(
        self,
        model: DALLE,
        vae=None,
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
        mesh=None,
    ):
        config, dev = self._init_mesh(model, mesh, device, kv_dtype, decode_sparsity)
        super().__init__(
            config, vae, max_batch=max_batch, chunk_tokens=chunk_tokens, prefill_batch=prefill_batch,
            cond_scale=cond_scale, tokenizer=tokenizer, page_size=page_size, kv_pages=kv_pages,
            prefix_entries=prefix_entries, kv_dtype=kv_dtype, decode_sparsity=decode_sparsity,
            paged_decode_impl=paged_decode_impl, device=dev, resume_enabled=resume_enabled,
            preview_enabled=preview_enabled,
        )
