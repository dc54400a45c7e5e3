"""Ring attention: sequence-parallel attention over the mesh's ``seq`` axis
(``videogpa_tpu/ops/ring_attention.py``).

The tokens are split into P shards over the ``seq`` group; each rank keeps
its query shard, and the K/V shards rotate around the ring
(``torch.distributed.batch_isend_irecv`` to the next rank, from the previous
one), so each rank attends its queries to every key shard in P steps and
merges the partial outputs by their logsumexp (``_merge``). The backward runs
a second ring: dQ accumulates at home while each K/V shard travels with its
dK/dV accumulators, which are back at the shard's home after P hops. dQ, dK
and dV accumulate in float32 across the steps; O is merged in float32 and
cast back to the operands' dtype after each step, as in JAX.

Each (query shard, key shard) pair takes the kernels ``attention()`` picks
under grad (``_FlashAttention._pair``): on bf16 CUDA tensors K1
(``flash_attn_fwd`` with LSE) and K3 (``flash_attn_bwd``, fed the global LSE
and the merged O) at head_dim < 128, K6 and K7 at 128, the f32 and wide
entries where the dtype or head_dim call for them; on CPU tensors their
plain versions. The kernels take no key mask, so a sequence that P does not
divide is padded to a multiple of P and each resident shard is full, a valid
prefix (a sliced view of the keys) or empty: an empty shard launches
nothing and contributes O = 0 with LSE = -1e30, as JAX's flash branch does.
A general ``kv_mask`` (any keys excluded) rotates with K/V and each pair
attends to the selected keys only.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from videogpa_torch.ops.attention import _FlashAttention, _round_up

# finite stand-in for "no valid keys on this shard": keeps the logsumexp
# merge nan-free (exp(-1e30 - x) == 0) while zeroing the shard's weight
_EMPTY_LSE = -1e30


def _seq_dim(layout: str) -> int:
    if layout not in ("bhnd", "bnhd"):
        raise ValueError(f"layout must be 'bhnd' or 'bnhd', got {layout!r}")
    return 2 if layout == "bhnd" else 1


def _per_row(w: torch.Tensor, layout: str) -> torch.Tensor:
    """A (B, H, n) per-row weight broadcast against an O in ``layout``."""
    return (w if layout == "bhnd" else w.transpose(1, 2))[..., None]


def _selected(kv_mask: torch.Tensor) -> Optional[torch.Tensor]:
    """Indices of the keys ``kv_mask`` keeps (None: all of them)."""
    keep = (kv_mask > 0).nonzero().flatten()
    return None if keep.numel() == kv_mask.numel() else keep


def _attn_with_lse(q, k, v, kv_mask=None, layout: str = "bhnd",
                   softmax_scale: Optional[float] = None):
    """(O, LSE) of queries ``q`` against one key shard (JAX's
    ``_attn_with_lse_xla`` :35 and ``_attn_with_lse_flash`` :55 in one).

    q: (B, H, n, D) ("bhnd") or (B, n, H, D) ("bnhd"); k, v the shard's m
    keys in the same layout. LSE is (B, H, n) float32, natural log.
    ``kv_mask`` (m,), optional: keys where it is 0 are left out; with none
    left, O = 0 and LSE = -1e30 and nothing launches."""
    seq = _seq_dim(layout)
    if kv_mask is not None:
        keep = _selected(kv_mask)
        if keep is not None:
            if keep.numel() == 0:
                return _empty_like(q, layout)
            k, v = k.index_select(seq, keep), v.index_select(seq, keep)
    fwd = _FlashAttention._pair(q)[0]
    return fwd(q, k, v, layout=layout, with_lse=True, softmax_scale=softmax_scale)


def _empty_like(q, layout: str):
    """(O, LSE) of a shard with no valid keys: O = 0, LSE = -1e30, no launch."""
    o = torch.zeros_like(q)
    B, n = q.shape[0], q.shape[_seq_dim(layout)]
    H = q.shape[1] if layout == "bhnd" else q.shape[2]
    return o, q.new_full((B, H, n), _EMPTY_LSE, dtype=torch.float32)


def _merge(o, lse, o_i, lse_i, layout: str = "bhnd"):
    """Combine two online-softmax partials (JAX ``_merge`` :88): the
    weights exp(lse - new_lse) in float32, O merged in float32 and cast back
    to its dtype."""
    new_lse = torch.logaddexp(lse, lse_i)
    w0 = _per_row(torch.exp(lse - new_lse), layout)
    w1 = _per_row(torch.exp(lse_i - new_lse), layout)
    return (o.float() * w0 + o_i.float() * w1).to(o.dtype), new_lse


def _bwd_step(q, k, v, o, lse, do, kv_mask=None, layout: str = "bhnd",
              softmax_scale: Optional[float] = None):
    """(dQ, dK, dV) of one (query shard, key shard) pair (JAX
    ``_bwd_step_xla`` :184 and ``_bwd_step_flash`` :209): P is recomputed
    from the GLOBAL logsumexp ``lse`` and delta = rowsum(O * dO) from the
    MERGED output ``o``, so the pair's share is already normalised. Keys
    ``kv_mask`` leaves out get zero dK and dV rows."""
    seq = _seq_dim(layout)
    keep = None if kv_mask is None else _selected(kv_mask)
    kk, vv = k, v
    if keep is not None:
        if keep.numel() == 0:
            return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
        kk, vv = k.index_select(seq, keep), v.index_select(seq, keep)
    bwd = _FlashAttention._pair(q)[1]
    dq, dk, dv = bwd(q, kk, vv, o, lse, do, layout=layout, softmax_scale=softmax_scale)
    if keep is not None:
        dk = torch.zeros_like(k).index_copy_(seq, keep, dk)
        dv = torch.zeros_like(v).index_copy_(seq, keep, dv)
    return dq, dk, dv


def _shard_validity(n_valid: int, shard_len: int) -> Tuple[int, int]:
    """(full shards, valid keys of the partial shard) of a padded sequence
    whose first ``n_valid`` keys are valid (JAX :102): shard r is full when
    r < full, a valid prefix of ``partial`` keys when r == full and
    partial > 0, and empty after."""
    return divmod(n_valid, shard_len)


def _resident_shard(rank: int, i: int, n: int) -> int:
    """Shard held by ``rank`` at ring step i (the rotation is j -> j + 1)."""
    return (rank - i) % n


def _resident_keys(r: int, shard_len: int, validity: Optional[Tuple[int, int]]) -> int:
    """How many of resident shard r's keys are valid (a prefix)."""
    if validity is None:
        return shard_len
    full, partial = validity
    return shard_len if r < full else (partial if r == full else 0)


def _pair_forward(q, k_cur, v_cur, m_cur, n_keys, layout, softmax_scale):
    """One forward pair; ``n_keys`` valid keys in front (0: empty shard)."""
    if n_keys == 0:
        return _empty_like(q, layout)
    seq = _seq_dim(layout)
    if n_keys < k_cur.shape[seq]:
        k_cur, v_cur = k_cur.narrow(seq, 0, n_keys), v_cur.narrow(seq, 0, n_keys)
    return _attn_with_lse(q, k_cur, v_cur, m_cur, layout, softmax_scale)


def _pair_backward(q, k_cur, v_cur, m_cur, o, lse, do, n_keys, layout, softmax_scale):
    """One backward pair: (dQ, dK, dV) with dK and dV of the ``n_keys``
    valid rows only, or None for an empty shard."""
    if n_keys == 0:
        return None
    seq = _seq_dim(layout)
    if n_keys < k_cur.shape[seq]:
        k_cur, v_cur = k_cur.narrow(seq, 0, n_keys), v_cur.narrow(seq, 0, n_keys)
    return _bwd_step(q, k_cur, v_cur, o, lse, do, m_cur, layout, softmax_scale)


def _rotate(tensors: List[torch.Tensor], group, rank: int, n: int):
    """Start sending each tensor to the next rank of ``group``'s ring and
    receiving the previous rank's: returns (buffers, requests). The peers
    are global ranks (``batch_isend_irecv`` takes those)."""
    import torch.distributed as dist

    nxt = dist.get_global_rank(group, (rank + 1) % n)
    prv = dist.get_global_rank(group, (rank - 1) % n)
    recv = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, r, prv, group) for r in recv]
    return recv, dist.batch_isend_irecv(ops)


def _wait(requests) -> None:
    for req in requests:
        req.wait()


def _ring_forward(q, k, v, mask, group, n_valid, layout, softmax_scale):
    """(O, LSE) of this rank's query shard against every key shard (JAX
    :128). The next rotation is in flight while a pair computes."""
    import torch.distributed as dist

    rank, n = dist.get_rank(group), dist.get_world_size(group)
    L = k.shape[_seq_dim(layout)]
    validity = None if n_valid is None else _shard_validity(n_valid, L)
    o = lse = None
    cur = [k, v] + ([mask] if mask is not None else [])
    for i in range(n):
        nxt, reqs = _rotate(cur, group, rank, n) if i + 1 < n else (None, [])
        n_keys = _resident_keys(_resident_shard(rank, i, n), L, validity)
        o_i, lse_i = _pair_forward(q, cur[0], cur[1], cur[2] if mask is not None else None,
                                   n_keys, layout, softmax_scale)
        o, lse = (o_i, lse_i) if o is None else _merge(o, lse, o_i, lse_i, layout)
        _wait(reqs)
        cur = nxt
    return o, lse


def _ring_backward(q, k, v, mask, o, lse, do, group, n_valid, layout, softmax_scale):
    """(dQ, dK, dV) in float32 (JAX :249): dQ accumulates at home; each K/V
    shard rotates with its dK/dV accumulators, home again after P hops."""
    import torch.distributed as dist

    rank, n = dist.get_rank(group), dist.get_world_size(group)
    seq = _seq_dim(layout)
    L = k.shape[seq]
    validity = None if n_valid is None else _shard_validity(n_valid, L)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    kv = [k, v] + ([mask] if mask is not None else [])
    for i in range(n):
        nxt, reqs = _rotate(kv, group, rank, n) if i + 1 < n else (None, [])
        n_keys = _resident_keys(_resident_shard(rank, i, n), L, validity)
        grads = _pair_backward(q, kv[0], kv[1], kv[2] if mask is not None else None,
                               o, lse, do, n_keys, layout, softmax_scale)
        if grads is not None:
            dq_i, dk_i, dv_i = grads
            dq += dq_i.float()
            dk.narrow(seq, 0, n_keys).add_(dk_i.float())
            dv.narrow(seq, 0, n_keys).add_(dv_i.float())
        _wait(reqs)
        kv = nxt
        if n > 1:  # the accumulators travel with their shard, home after n hops
            (dk, dv), acc_reqs = _rotate([dk, dv], group, rank, n)
            _wait(acc_reqs)
    return dq, dk, dv


class _Ring(torch.autograd.Function):
    """The ring with its backward ring (JAX's ``custom_vjp`` :316-327)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, group, n_valid, layout, softmax_scale):
        o, lse = _ring_forward(q, k, v, mask, group, n_valid, layout, softmax_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask, ctx.group, ctx.n_valid = mask, group, n_valid
        ctx.layout, ctx.softmax_scale = layout, softmax_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, ctx.mask, o, lse, do.contiguous(), ctx.group,
                                    ctx.n_valid, ctx.layout, ctx.softmax_scale)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                   kv_mask: Optional[torch.Tensor] = None, n_valid: Optional[int] = None,
                   layout: str = "bhnd", softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Sequence-sharded attention body (JAX :330), on this rank's shards.

    Args:
        q, k, v: this rank's shards, (B, H, N/P, D) (or (B, N/P, H, D) with
            ``layout="bnhd"``), contiguous.
        group: the ``seq`` process group; the shards are in its rank order.
        kv_mask: optional (N/P,) key validity of this rank's shard; it
            rotates with K/V, so any keys may be left out.
        n_valid: optional count of valid tokens of the global padded
            sequence (a valid prefix, as ``ring_attention_sharded`` pads):
            each resident shard is full, a prefix (a sliced view) or empty.
            Mutually exclusive with ``kv_mask``.

    Returns:
        this rank's output shard, in q's layout and dtype.
    """
    if kv_mask is not None and n_valid is not None:
        raise ValueError("pass kv_mask or n_valid, not both")
    mask = None if kv_mask is None else kv_mask.to(torch.float32).contiguous()
    return _Ring.apply(q, k, v, mask, group, n_valid, layout, softmax_scale)


class _TakeShard(torch.autograd.Function):
    """This rank's shard of a replicated tensor; the backward gathers every
    rank's shard gradient (each rank computes its own, so a sum would count
    each P times)."""

    @staticmethod
    def forward(ctx, x, group, rank, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        L = x.shape[dim] // n
        return x.narrow(dim, rank * L, L).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.n, ctx.dim), None, None, None, None


class _GatherShards(torch.autograd.Function):
    """Every rank's output shard, concatenated; the backward keeps this
    rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group, rank, n, dim):
        ctx.rank, ctx.dim, ctx.L = rank, dim, x.shape[dim]
        return _gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.L, ctx.L).contiguous(), None, None, None, None


def _gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    import torch.distributed as dist

    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _pad_to(x: torch.Tensor, dim: int, length: int) -> torch.Tensor:
    if x.shape[dim] == length:
        return x
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, length - x.shape[dim]]
    return torch.nn.functional.pad(x, pad)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                           seq_axis: str = "seq", layout: str = "bhnd",
                           softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention on whole (replicated) tensors (JAX :377): each rank
    takes its shard of the sequence over ``mesh``'s ``seq_axis``, runs the
    ring and gathers the output shards, so O is whole on every rank, as
    JAX's ``shard_map`` returns it. The query and key lengths are padded to
    multiples of the axis size; padded keys are excluded exactly by the
    static shard validity (``n_valid``), padded query rows are sliced off.

    Gradients flow to q, k and v whole on every rank: the shard's backward
    gathers every rank's shard gradient, the output gather's backward keeps
    this rank's rows."""
    from videogpa_torch.parallel.mesh import axis_rank, axis_size

    seq = _seq_dim(layout)
    n = axis_size(mesh, seq_axis)
    group, rank = mesh.get_group(seq_axis), axis_rank(mesh, seq_axis)
    Nq, Nk = q.shape[seq], k.shape[seq]
    Nq_pad, Nk_pad = _round_up(Nq, n), _round_up(Nk, n)
    q = _TakeShard.apply(_pad_to(q, seq, Nq_pad), group, rank, n, seq)
    k, v = (_TakeShard.apply(_pad_to(x, seq, Nk_pad), group, rank, n, seq) for x in (k, v))
    o = ring_attention(q, k, v, group, n_valid=Nk if Nk_pad != Nk else None, layout=layout,
                       softmax_scale=softmax_scale)
    o = _GatherShards.apply(o, group, rank, n, seq)
    return o.narrow(seq, 0, Nq) if Nq_pad != Nq else o
