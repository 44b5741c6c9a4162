"""Ring attention: exact attention over a sequence split across the ranks
of the mesh's `sp` axis; the port's counterpart of the JAX package's
`parallel/ring.py` (`ring_attention`, `ring_attention_sharded`).

Each sp rank holds one block of queries and one block of keys and
values; the K/V blocks travel around the ring (`Collectives.ring_shift`,
one hop a step: the JAX ring's `ppermute`) while a streaming log-sum-exp
(m, l and acc in float32, as the JAX scan carries them) builds the exact
softmax. The per-block products are plain `torch.matmul` in float32 on
the blocks' values (the JAX ring is an `einsum` with float32 results,
outside any Pallas kernel); P is cast to V's type before P V, as the JAX
ring casts it.

The backward is written by hand (`_RingAttention.backward`): JAX
differentiates through `ppermute`, and torch cannot differentiate through
a send and a receive. It recomputes P of each block from the saved
log-sum-exp, keeps dq on the rank, and sends the dk / dv accumulators
around the ring with their K/V block, P hops in all, so that each
arrives home with every rank's share.

`ring_attention_sharded(mesh, q, k, v)` takes the whole sequence, which
every sp rank holds (the trunk outside attention runs whole on each of
them: the token shift and the masks cross block edges), takes this rank's
block of q, k and v, runs the ring and all-gathers the outputs over sp.
The backward of that all-gather keeps this rank's slice (every consumer is
replicated, so its gradient is the same on every rank) and the backward
of the block's selection all-gathers dq, dk and dv: no gradient then
needs a sum over sp. The batch is what this rank holds: the data axes
(dp, fsdp) split it before the model (the JAX wrapper's batch rule is the
step's row split, `training/steps.py`), and a batch the data ranks share
(the in-loop sample) runs whole on each.
"""

from __future__ import annotations

import torch

_NEG = -1e30


def _ring(mesh):
    """(group, ranks, index, size, comm) of this rank's sp ring."""
    ranks = mesh.group_ranks("sp")
    return mesh.group("sp"), ranks, ranks.index(mesh.rank), len(ranks), mesh.comm


def _block_scores(qs: torch.Tensor, k_blk: torch.Tensor, q_pos, k_pos, causal: bool) -> torch.Tensor:
    s = torch.matmul(qs, k_blk.float().transpose(-1, -2))
    if causal:
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], _NEG)
    return s


class _RingAttention(torch.autograd.Function):
    """Per-rank blocks q, k, v [B, H, n, D] -> [B, H, n, D]; rank i of the
    ring owns positions [i * n, (i + 1) * n)."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, causal: bool, scale: float):
        group, ranks, idx, size, comm = _ring(mesh)
        n = q.shape[2]
        dev = q.device
        with torch.autocast(dev.type, enabled=False):
            qs = q.float() * scale
            q_pos = idx * n + torch.arange(n, device=dev)
            m = torch.full(q.shape[:-1] + (1,), _NEG, dtype=torch.float32, device=dev)
            l = torch.zeros_like(m)
            acc = torch.zeros(q.shape, dtype=torch.float32, device=dev)
            kv = torch.stack([k, v])
            for s in range(size):
                kv_idx = (idx - s) % size
                k_pos = kv_idx * n + torch.arange(n, device=dev)
                scores = _block_scores(qs, kv[0], q_pos, k_pos, causal)
                m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
                corr = torch.exp(m - m_new)
                p = torch.exp(scores - m_new)
                l = l * corr + p.sum(dim=-1, keepdim=True)
                acc = acc * corr + torch.matmul(p.to(v.dtype).float(), kv[1].float())
                m = m_new
                if s + 1 < size:  # the block goes one hop on; the last stays
                    kv = comm.ring_shift(kv, group, ranks, idx)
            out = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
            lse = m + torch.log(torch.clamp(l, min=1e-30))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mesh, ctx.causal, ctx.scale = mesh, causal, scale
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        group, ranks, idx, size, comm = _ring(ctx.mesh)
        scale, causal = ctx.scale, ctx.causal
        n = q.shape[2]
        dev = q.device
        with torch.autocast(dev.type, enabled=False):
            qs = q.float() * scale
            do = d_out.float()
            delta = (do * out.float()).sum(dim=-1, keepdim=True)
            q_pos = idx * n + torch.arange(n, device=dev)
            dq = torch.zeros(q.shape, dtype=torch.float32, device=dev)
            # K, V and their gradient accumulators travel together
            blk = torch.stack([k.float(), v.float(), torch.zeros_like(qs), torch.zeros_like(qs)])
            for s in range(size):
                kv_idx = (idx - s) % size
                k_pos = kv_idx * n + torch.arange(n, device=dev)
                kb, vb = blk[0], blk[1]
                p = torch.exp(_block_scores(qs, kb, q_pos, k_pos, causal) - lse)
                dp = torch.matmul(do, vb.transpose(-1, -2))
                ds = p * (dp - delta)
                dq += torch.matmul(ds, kb) * scale
                blk[2] += torch.matmul(ds.transpose(-1, -2), qs)
                blk[3] += torch.matmul(p.transpose(-1, -2), do)
                # every step a hop: after `size` hops each block is home
                blk = comm.ring_shift(blk, group, ranks, idx)
        return dq.to(q.dtype), blk[2].to(k.dtype), blk[3].to(v.dtype), None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   causal: bool = True) -> torch.Tensor:
    """This rank's blocks q, k, v [B, H, n_local, D] (rank i of the sp ring
    owning positions [i * n_local, (i + 1) * n_local)) -> its output block,
    scaled by D ** -0.5 (the JAX `ring_attention`'s default scale; its
    `axis_name` is always the mesh's sp axis here). Every rank of the ring
    calls it together."""
    return _RingAttention.apply(q, k, v, mesh, causal, q.shape[-1] ** -0.5)


class _TakeBlock(torch.autograd.Function):
    """This rank's block of a sequence every sp rank holds whole; the
    backward all-gathers the blocks' gradients (each rank computed its
    own block's), so every rank gets the whole gradient."""

    @staticmethod
    def forward(ctx, x, mesh, dim: int):
        group, ranks, idx, size, _ = _ring(mesh)
        ctx.mesh, ctx.dim = mesh, dim
        return x.chunk(size, dim)[idx].contiguous()

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        return mesh.comm.all_gather(grad.contiguous(), mesh.group("sp"), ctx.dim), None, None


class _JoinBlocks(torch.autograd.Function):
    """The whole sequence from the sp ranks' blocks (an all-gather); the
    backward keeps this rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, mesh, dim: int):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.comm.all_gather(x.contiguous(), mesh.group("sp"), dim)

    @staticmethod
    def backward(ctx, grad):
        group, ranks, idx, size, _ = _ring(ctx.mesh)
        return grad.chunk(size, ctx.dim)[idx].contiguous(), None, None


def ring_attention_sharded(mesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           causal: bool = True) -> torch.Tensor:
    """q, k, v [B, H, N, D], the whole sequence on every rank of `mesh`'s
    sp axis (the JAX wrapper's `seq_axis`, which the trainer never sets
    otherwise); returns the whole [B, H, N, D] output on every one, each
    rank having computed its block of it by `ring_attention`."""
    qkv = _TakeBlock.apply(torch.stack([q, k, v]), mesh, 3)
    out = ring_attention(qkv[0], qkv[1], qkv[2], mesh, causal=causal)
    return _JoinBlocks.apply(out, mesh, 2)
