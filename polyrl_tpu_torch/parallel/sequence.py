"""Sequence/context parallelism: Ulysses all-to-all and ring attention.

Counterpart of ``polyrl_tpu/parallel/sequence.py``. The reference's
long-context training mechanism is verl's Ulysses SP: sequences sliced
along their length over ranks, attention computed after an all-to-all that
trades the sequence split for a head split. Ring attention is the
context-parallel mode for sequences no single device can hold.

Both take this rank's slice: q/k/v ``[b, T/sp, H, D]`` and ``token_mask``
``[b, T/sp]`` (left-pad aware), the columns of global positions
``coords[sp] * T/sp`` onward, and apply causal masking over GLOBAL
positions. ``packed=True`` returns the segment-aware variant, whose
signature gains a trailing ``segment_ids`` ``[b, T/sp]`` (0 = pad,
1-based per row); a segment may span the rank boundary, since the
exchange re-unifies the sequence (or rotates the ids with their K/V
block) before masking.

- Ulysses: ``all_to_all`` over the ``sp`` group gives each rank the whole
  sequence for H/sp heads; attention there is ``ops/flash``'s
  ``flash_attention_train`` with the gathered mask and segment ids (K4 on
  the card, its plain version on the CPU); the reverse exchange gives back
  the sequence split. Each exchange is an autograd function whose backward
  is the other exchange.
- Ring: K/V (with their mask and segment ids) rotate around the ``sp``
  ring, merged into an online softmax over global positions. The JAX
  body is plain einsums with no Pallas kernel, so plain tensor code is the
  port; autograd runs through the rotations, whose backward rotates the
  gradients back.
"""

from __future__ import annotations

import functools

import torch

from polyrl_tpu_torch.ops import flash
from polyrl_tpu_torch.parallel.mesh import SP, Mesh, all_gather, all_to_all, rotate

_NEG = -0.7 * float(torch.finfo(torch.float32).max)  # finite -inf (no exp NaNs)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA: repeat each KV head ``n_rep`` times in place ([B, T, Hkv, D] ->
    [B, T, Hkv * n_rep, D], head h to heads h*n_rep ... h*n_rep + n_rep - 1)."""
    if n_rep == 1:
        return x
    b, t, h, d = x.shape
    return x[:, :, :, None, :].expand(b, t, h, n_rep, d).reshape(b, t, h * n_rep, d)


def _expand_kv_minimal(k, v, hq: int, sp: int):
    """GQA under Ulysses: KV heads ride the same all-to-all as Q heads, so
    their count must divide by sp. When ``hkv % sp != 0``, expand by the
    SMALLEST factor r (r must divide the GQA group hq/hkv so head to group
    association survives the head split, and make hkv*r % sp == 0), full
    expansion to hq only as the last resort."""
    hkv = k.shape[2]
    if hkv % sp == 0:
        return k, v
    group = hq // hkv
    r = next((r for r in range(2, group + 1)
              if group % r == 0 and (hkv * r) % sp == 0), group)
    return repeat_kv(k, r), repeat_kv(v, r)


# --------------------------------------------------------------------------
# Ulysses
# --------------------------------------------------------------------------


def _seq_to_heads(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """[b, T/sp, H, D] -> [b, T, H/sp, D]: head block j goes to rank j,
    the sequence blocks come back in rank order."""
    sp = mesh.shape[axis]
    b, ts, h, d = x.shape
    blocks = x.reshape(b, ts, sp, h // sp, d).permute(2, 0, 1, 3, 4)
    got = all_to_all(mesh, (axis,), blocks.contiguous())
    return got.permute(1, 0, 2, 3, 4).reshape(b, sp * ts, h // sp, d)


def _heads_to_seq(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_seq_to_heads``: [b, T, H/sp, D] -> [b, T/sp, H, D]."""
    sp = mesh.shape[axis]
    b, t, hs, d = x.shape
    blocks = x.reshape(b, sp, t // sp, hs, d).permute(1, 0, 2, 3, 4)
    got = all_to_all(mesh, (axis,), blocks.contiguous())
    return got.permute(1, 2, 0, 3, 4).reshape(b, t // sp, sp * hs, d)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _seq_to_heads(mesh, axis, x)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(ctx.mesh, ctx.axis, g.contiguous()), None, None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _heads_to_seq(mesh, axis, x)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(ctx.mesh, ctx.axis, g.contiguous()), None, None


def _gather_cols(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """[b, T/sp] -> [b, T] over the sp group (no gradient: masks, ids)."""
    blocks = all_gather(mesh, (axis,), x.contiguous())     # [sp, b, ts]
    return blocks.permute(1, 0, 2).reshape(x.shape[0], -1).contiguous()


def make_ulysses_attention(mesh: Mesh, axis: str = SP, packed: bool = False):
    """attn_fn(q, k, v, token_mask) -> out on this rank's sequence slice
    (``packed=True``: a trailing ``segment_ids``). The gathered
    full-sequence attention is ``flash_attention_train``, causal, with the
    gathered segment ids (K4 with segment ids on the card); without
    explicit ids padding rides the mask-derived ones, as on one device."""

    def attn(q, k, v, token_mask, segment_ids=None):
        sp = mesh.shape[axis]
        if q.shape[2] % sp:
            raise ValueError(f"ulysses needs num_heads ({q.shape[2]}) "
                             f"divisible by sp ({sp})")
        k, v = _expand_kv_minimal(k, v, q.shape[2], sp)
        q_g = _SeqToHeads.apply(q, mesh, axis)
        k_g = _SeqToHeads.apply(k, mesh, axis)
        v_g = _SeqToHeads.apply(v, mesh, axis)
        mask_g = _gather_cols(mesh, axis, token_mask)
        seg_g = (_gather_cols(mesh, axis, segment_ids)
                 if segment_ids is not None else None)
        out = flash.flash_attention_train(q_g, k_g, v_g, mask_g, causal=True,
                                          segment_ids=seg_g)
        return _HeadsToSeq.apply(out, mesh, axis)

    if packed:
        return attn
    return lambda q, k, v, token_mask: attn(q, k, v, token_mask)


# --------------------------------------------------------------------------
# Ring attention
# --------------------------------------------------------------------------


class _Rotate(torch.autograd.Function):
    """One ring step forward; its backward rotates the gradient back."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return rotate(mesh, axis, x, 1)

    @staticmethod
    def backward(ctx, g):
        return rotate(ctx.mesh, ctx.axis, g.contiguous(), -1), None, None


def ring_attention_local(q, k, v, token_mask, segment_ids=None, *,
                         mesh: Mesh, axis: str = SP):
    """The ring-attention body on this rank's blocks: q/k/v ``[b, T/sp, H,
    D]``; K/V (with their mask and segment ids) rotate around the ring,
    merged by an online softmax over GLOBAL positions, in f32.

    GQA-native: heads never leave their rank, so KV is NOT expanded; the
    rotating K/V blocks stay at hkv heads and Q heads group against their
    shared KV head in the einsum."""
    sp = mesh.shape[axis]
    b, tq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    idx = mesh.coords[axis]
    dev = q.device
    q32 = q.reshape(b, tq, hkv, g, d).float() * scale
    q_pos = idx * tq + torch.arange(tq, device=dev)  # global positions

    m = torch.full((b, hkv, g, tq), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, tq), dtype=torch.float32, device=dev)
    o = torch.zeros((b, tq, hkv, g, d), dtype=torch.float32, device=dev)
    k_cur, v_cur, mask_cur, seg_cur = k, v, token_mask, segment_ids

    for step in range(sp):
        src = (idx - step) % sp  # the block this rank holds now
        tk = k_cur.shape[1]
        logits = torch.einsum("bqhgd,bkhd->bhgqk", q32, k_cur.float())
        kv_pos = src * tk + torch.arange(tk, device=dev)
        ok = (kv_pos[None, :] <= q_pos[:, None])[None, None, None]
        ok = ok & (mask_cur[:, None, None, None, :] > 0)
        if seg_cur is not None:
            ok = ok & (segment_ids[:, :, None]
                       == seg_cur[:, None, :])[:, None, None]
        logits = torch.where(ok, logits, _NEG)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        p = torch.where(ok, p, 0.0)
        corr = torch.exp(m - m_new)                      # [b, hkv, g, tq]
        l = l * corr + p.sum(dim=-1)
        o = o * corr.permute(0, 3, 1, 2)[..., None] + torch.einsum(
            "bhgqk,bkhd->bqhgd", p, v_cur.float())
        m = m_new
        if step < sp - 1:
            k_cur = _Rotate.apply(k_cur.contiguous(), mesh, axis)
            v_cur = _Rotate.apply(v_cur.contiguous(), mesh, axis)
            mask_cur = rotate(mesh, axis, mask_cur.contiguous())
            if seg_cur is not None:
                seg_cur = rotate(mesh, axis, seg_cur.contiguous())

    denom = torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
    return (o / denom).reshape(b, tq, hq, d).to(q.dtype)


def make_ring_attention(mesh: Mesh, axis: str = SP, packed: bool = False):
    """attn_fn(q, k, v, token_mask) -> out around ``ring_attention_local``
    (``packed=True``: a trailing ``segment_ids`` that rotates with its K/V
    block, the mask adding same-segment equality)."""
    fn = functools.partial(ring_attention_local, mesh=mesh, axis=axis)
    if packed:
        return fn
    return lambda q, k, v, token_mask: fn(q, k, v, token_mask)


def make_sp_attention(mesh: Mesh, mode: str, axis: str = SP,
                      packed: bool = False):
    """Dispatch: 'ulysses' | 'ring' | 'dense' (None)."""
    if mode == "ulysses":
        return make_ulysses_attention(mesh, axis, packed=packed)
    if mode == "ring":
        return make_ring_attention(mesh, axis, packed=packed)
    if mode in ("dense", "none", None):
        return None
    raise ValueError(f"unknown sp attention mode {mode!r}")
