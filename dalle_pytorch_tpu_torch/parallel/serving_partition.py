"""Placement rules of the serving decode state: the counterpart of the JAX
package's `parallel/serving_partition.py` (`decode_state_spec`,
`decode_state_shardings`; its parameter rules are `partition.py`'s, and
the VAE stays whole on shard 0).

  K/V          k, v              [B|P, H, L, D] -> heads over tp
  int8 scales  k_scale, v_scale  [B|P, H, L]    -> heads over tp
  pending logits  row            [S, V]         -> vocabulary over tp
  shift rings, per-row scalars (img_pos, active, temps, keep_k,
  img_tokens, the cache index)                  -> replicated

Both layouts share the tree keys: the slotted cache's lanes [B, H, L, D]
and the paged pool [P, H, page, D] split at the heads, and the page axis
never splits (the host page tables address pages globally). Every spec
passes through `partition._divisible`, so a head count or vocabulary that
the axis does not divide is replicated.

`place_decode_state` turns one whole state into a state per shard: a split
leaf gives each shard its piece, a replicated one a copy, each on its
shard's device; the host mirrors (`"host"`) stay one object shared by all.
The pending logits follow the model's logits head (`split_row`): a head
that stays whole (a tied head whose two vocabularies the axis does not
divide, though their sum may) gives every shard the whole row.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch

from dalle_pytorch_tpu_torch.parallel.mesh import DeviceMesh
from dalle_pytorch_tpu_torch.parallel.partition import (
    MODEL_AXIS,
    Placement,
    _divisible,
    split_tensor,
)

#: the axis KV heads and vocabulary columns split over
SERVING_MODEL_AXIS = MODEL_AXIS

_ROW_SCALAR_KEYS = frozenset({"img_pos", "active", "temps", "keep_k", "img_tokens", "index"})
_RING_KEYS = frozenset({"shift_attn", "shift_ff"})


def decode_state_spec(path: Sequence[str], leaf: torch.Tensor, model_axis: str = SERVING_MODEL_AXIS) -> tuple:
    """The spec of one decode-state leaf at tree path `path`, before
    `_divisible`."""
    key = path[-1] if path else ""
    rank = leaf.dim()
    if key in ("k", "v"):
        if rank != 4:
            raise ValueError(f"unexpected cache leaf {key} of rank {rank}")
        return (None, model_axis)
    if key in ("k_scale", "v_scale"):
        if rank != 3:
            raise ValueError(f"unexpected scale leaf {key} of rank {rank}")
        return (None, model_axis)
    if key in _RING_KEYS or key in _ROW_SCALAR_KEYS:
        return ()
    if key == "row":
        return (None, model_axis)
    return ()  # anything unrecognized replicates


def _leaves(tree: dict, path=()):
    for key, val in tree.items():
        if key == "host":
            continue
        if isinstance(val, dict):
            yield from _leaves(val, path + (key,))
        elif torch.is_tensor(val):
            yield path + (key,), val


def decode_state_placements(state: dict, mesh: DeviceMesh, model_axis: str = SERVING_MODEL_AXIS,
                            split_row: bool = True) -> Dict[tuple, Placement]:
    """{tree path: Placement} of every tensor leaf of a decode state; the
    pending logits `row` replicated unless `split_row`."""
    out = {}
    for path, leaf in _leaves(state):
        spec = decode_state_spec(path, leaf, model_axis)
        if path[-1] == "row" and not split_row:
            spec = ()
        out[path] = Placement(_divisible(spec, leaf.shape, mesh))
    return out


def place_decode_state(state: dict, mesh: DeviceMesh, model_axis: str = SERVING_MODEL_AXIS,
                       split_row: bool = True) -> List[dict]:
    """One state per device along `model_axis`, each leaf that shard's
    piece (or a copy) on its device; `state["host"]` shared; `split_row`
    as `decode_state_placements`."""
    devices = mesh.axis_devices(model_axis)
    placements = decode_state_placements(state, mesh, model_axis, split_row)

    def build(tree, path, s):
        out = {}
        for key, val in tree.items():
            if key == "host" and not path:
                out[key] = val
            elif isinstance(val, dict):
                out[key] = build(val, path + (key,), s)
            elif torch.is_tensor(val):
                piece = split_tensor(val, placements[path + (key,)], len(devices), model_axis)[s]
                out[key] = piece.to(devices[s], copy=True).contiguous()
            else:
                out[key] = val
        return out

    return [build(state, (), s) for s in range(len(devices))]


def state_bytes(state: Any) -> int:
    """Bytes of every tensor leaf of a (shard's) decode state."""
    if torch.is_tensor(state):
        return state.numel() * state.element_size()
    if isinstance(state, dict):
        return sum(state_bytes(v) for k, v in state.items() if k != "host")
    return 0
