"""Ring attention: sequence parallelism over a mesh's ``sp`` axis
(counterpart of ``mxnet_tpu/parallel/ring_attention.py``).

Each rank keeps its block of queries while the key/value blocks travel
around the ring of the ``sp`` axis, one neighbour hop a step. A visiting
block is attended by a blockwise function that returns (out, lse), and
the blocks merge by the logsumexp combine, so the ring is flash attention
spread over ranks. The block function is the flash kernels
(``ops/flash_attention.flash_attention_with_lse``; on CPU tensors their
plain versions) at the causal offset ``(my - src) * s_loc`` for blocks of
``_FLASH_BLOCK_MIN_SEQ`` rows or more, and plain PyTorch einsums below.
Offset 0 is a rank's own (diagonal) block; an offset of ``-s_loc`` or
less is a block that lies wholly in its future (every row sees nothing:
out 0, lse -1e30), ``+s_loc`` or more one wholly in its past.

The reference runs the ring inside ``shard_map`` with ``lax.ppermute``;
here every rank is a process, and :func:`ring_attention` runs on its
local blocks with a differentiable neighbour exchange (``_Rotate``: the
backward is the reverse rotation). How the exchange moves bytes is
chosen in one place, :func:`exchange_route`, by the ``sp`` group's
backend and the tensors' device:

- ``nccl``: ``batch_isend_irecv`` on the device tensors;
- ``gloo_host`` (every gloo group: ranks sharing a card or on the CPU,
  ``parallel/host_staged.py``): ``isend``/``irecv``, which that group
  moves through host copies (gloo's own point-to-point transport aborts
  on CUDA tensors).

:func:`sequence_sharded_attention` is the global-view entry point of the
model code: given (B, H, S, D) ``DTensor``s over a mesh, it takes each
rank's block (B over ``dp``, H over ``tp``, S over ``sp``), runs the ring
and returns the output as a ``DTensor`` sharded the same way. A mesh whose
``sp`` axis has one rank reduces to plain attention.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from ..ops.attention import _contiguous, plain_attention
from ..ops.flash_attention import flash_attention_with_lse
from .mesh import Mesh, current_mesh

__all__ = ["ring_attention", "sequence_sharded_attention", "plain_attention",
           "exchange_route"]

_NEG = -1e30  # ops/flash_attention._NEG_INF
# rows per block at which the flash kernels take over the block math
_FLASH_BLOCK_MIN_SEQ = 1024


def _block_attn_einsum(q, k_blk, v_blk, s_loc, my_idx, src_idx, scale,
                       causal):
    """(out, lse) of one K/V block by einsums, scores in f32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k_blk).float() * scale
    if causal:
        ar = torch.arange(s_loc, device=q.device)
        rows = my_idx * s_loc + ar[:, None]
        cols = src_idx * s_loc + ar[None, :]
        s = torch.where(rows >= cols, s, _NEG)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(s <= _NEG / 2, 0.0, p)
    den = torch.sum(p, dim=-1)
    safe = torch.clamp_min(den, 1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v_blk).float() \
        / safe[..., None]
    lse = torch.where(den > 0, m + torch.log(safe), _NEG)
    return out, lse


def _block_attn_flash(q, k_blk, v_blk, s_loc, my_idx, src_idx, scale,
                      causal):
    """(out, lse) of one block through the flash kernels, at the causal
    offset that places the block in the global sequence."""
    offset = (my_idx - src_idx) * s_loc
    o, lse = flash_attention_with_lse(q, k_blk, v_blk, causal=causal,
                                      scale=scale, offset=offset)
    return o.float(), lse


def _combine(o, lse, o_blk, lse_blk):
    """Merge two normalized (out, lse) pairs: flash's logsumexp
    algebra."""
    new = torch.maximum(lse, lse_blk)
    w1 = torch.where(lse <= _NEG / 2, 0.0, torch.exp(lse - new))
    w2 = torch.where(lse_blk <= _NEG / 2, 0.0, torch.exp(lse_blk - new))
    den = w1 + w2
    safe = torch.clamp_min(den, 1e-30)
    o_new = (o * w1[..., None] + o_blk * w2[..., None]) / safe[..., None]
    lse_new = torch.where(den > 0, new + torch.log(safe), _NEG)
    return o_new, lse_new


# ---------------------------------------------------------------------------
# the neighbour exchange
# ---------------------------------------------------------------------------

def exchange_route(group, device: torch.device) -> str:
    """How the ring moves a block between the ranks of ``group``:
    ``"nccl"`` (device point-to-point) or ``"gloo_host"`` (the
    ``gloo_host`` group that every gloo job forms, which moves blocks
    through host copies). Any other backend raises: gloo's own
    point-to-point aborts the process on CUDA tensors."""
    import torch.distributed as dist

    backend = str(dist.get_backend(group))
    if "nccl" in backend:
        return "nccl"
    if "gloo_host" in backend:
        return "gloo_host"
    raise MXNetError(f"ring attention: no neighbour exchange of {device} "
                     f"tensors over a {backend!r} process group (form it "
                     "with kvstore.dist.join_process_group)")


def _exchange(x, group, dst: int, src: int):
    """Send ``x`` to global rank ``dst`` and return the block received
    from ``src``."""
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.empty_like(x)
    if exchange_route(group, x.device) == "nccl":
        ops = [dist.P2POp(dist.isend, x, dst, group),
               dist.P2POp(dist.irecv, out, src, group)]
        works = dist.batch_isend_irecv(ops)
    else:
        works = [dist.isend(x, dst, group), dist.irecv(out, src, group)]
    for w in works:
        w.wait()
    return out


class _Rotate(torch.autograd.Function):
    """One hop around the ring: every rank sends its block to the next
    rank and receives the previous one's. The backward sends the
    gradients the other way."""

    @staticmethod
    def forward(ctx, x, group, nxt, prv):
        ctx.ring = (group, nxt, prv)
        return _exchange(x, group, nxt, prv)

    @staticmethod
    def backward(ctx, g):
        group, nxt, prv = ctx.ring
        return _exchange(g, group, prv, nxt), None, None, None


def _ring_body(q, k, v, mesh: Mesh, axis_name, causal, scale,
               use_flash=None):
    """The ring on this rank's local blocks q, k, v (B, H, s_loc, D)."""
    import torch.distributed as dist

    group = mesh.group(axis_name)
    n = mesh.shape[axis_name]
    my_idx = mesh.axis_index(axis_name)
    nxt = dist.get_global_rank(group, (my_idx + 1) % n)
    prv = dist.get_global_rank(group, (my_idx - 1) % n)
    s_loc = q.shape[-2]
    scale = float(scale) if scale is not None else \
        1.0 / math.sqrt(q.shape[-1])
    if use_flash is None:
        use_flash = s_loc >= _FLASH_BLOCK_MIN_SEQ and s_loc % 8 == 0
    block_attn = _block_attn_flash if use_flash else _block_attn_einsum

    b, h, _, d = q.shape
    o = torch.zeros((b, h, s_loc, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, s_loc), _NEG, dtype=torch.float32,
                     device=q.device)
    # K and V travel together: one exchange a hop
    kv, src_idx = torch.stack([k, v]), my_idx
    for step in range(n):
        o_blk, lse_blk = block_attn(q, kv[0], kv[1], s_loc, my_idx, src_idx,
                                    scale, causal)
        o, lse = _combine(o, lse, o_blk, lse_blk)
        if step != n - 1:  # the last block needs no rotation
            kv = _Rotate.apply(kv, group, nxt, prv)
            src_idx = (src_idx - 1) % n
    return o.to(q.dtype)


def ring_attention(q, k, v, axis_name="sp", causal=False, scale=None,
                   use_flash=None, mesh: Mesh = None):
    """Attention of this rank's blocks q, k, v (B, H, s_loc, D), plain
    tensors sharded over ``axis_name`` of ``mesh`` (default: the mesh in
    scope), against the whole sequence; every rank of the axis calls it
    together. Returns this rank's block of the output."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise MXNetError("ring_attention needs a mesh (pass mesh= or call "
                         "it under parallel.mesh_scope)")
    return _ring_body(q, k, v, mesh, axis_name, causal, scale, use_flash)


def _as_dtensor(x, device_mesh):
    """``x`` as a ``DTensor``; a plain tensor is taken as the global value
    that every rank holds."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, device_mesh,
                              [Replicate()] * device_mesh.ndim,
                              run_check=False)


def sequence_sharded_attention(q, k, v, mesh: Mesh, axis_name: str = "sp",
                               causal: bool = False, scale=None,
                               batch_axis: str = "dp", head_axis: str = "tp",
                               use_flash=None):
    """Global-view attention sharded B over ``batch_axis``, H over
    ``head_axis`` (where they divide) and S over ``axis_name``.

    q, k, v: (B, H, S, D) global arrays: ``DTensor``s over the mesh's
    ``DeviceMesh``, or plain tensors that every rank holds whole. Returns
    the output as a ``DTensor`` in that sharding; a mesh whose
    ``axis_name`` has one rank reduces to plain attention."""
    from .sharding import P, _prune, NamedSharding

    sizes = mesh.shape
    if sizes.get(axis_name, 1) == 1:
        return plain_attention(q, k, v, causal=causal, scale=scale)
    if q.shape[-2] % sizes[axis_name]:
        raise ValueError(f"sequence length {q.shape[-2]} does not divide "
                         f"over {axis_name}={sizes[axis_name]}")
    b_ax = batch_axis if sizes.get(batch_axis, 1) > 1 else None
    h_ax = head_axis if sizes.get(head_axis, 1) > 1 else None
    spec = _prune(P(b_ax, h_ax, axis_name, None), mesh, tuple(q.shape))
    placements = NamedSharding(mesh, spec).placements
    dm = mesh.device_mesh
    local = [_as_dtensor(t, dm).redistribute(dm, placements).to_local()
             for t in (q, k, v)]
    out = _ring_body(*local, mesh, axis_name, causal, scale, use_flash)
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(out, dm, placements, run_check=False,
                              shape=q.shape, stride=_contiguous(q.shape))
