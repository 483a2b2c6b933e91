"""Pipeline parallelism: the GPipe microbatch schedule over the ``pp`` axis.

Counterpart of ``polyrl_tpu/parallel/pipeline.py``. The JAX package runs
the schedule as one program (a ``shard_map`` manual on ``pp``, a
``lax.scan`` over the steps, ``lax.ppermute`` between the stages) and lets
autodiff transpose it; here every rank is one stage and runs the same
rotating schedule itself:

- the stacked layer tree ``[L, ...]`` is split into ``pp`` stages of
  ``L/pp`` layers; rank ``i`` of the pp axis holds stage ``i``'s
  (``parallel/fsdp.py`` cuts them, ``stage_layers`` for a whole tree);
- at global step ``s`` in ``0 .. n+pp-2`` stage ``i`` runs its layers on
  microbatch ``s - i``; stage 0 reads the embedded microbatch, the others
  what ``mesh.rotate`` brought from the stage before, and the last stage
  writes the output slot ``s - (pp - 1)``. A stage outside its window
  (warm-up and drain) computes nothing and hands on zeros: nothing it
  holds reaches an output or a gradient;
- the outputs are summed over pp (only the last stage's are nonzero), so
  every rank holds them whole, as the JAX ``psum`` leaves them;
- the backward is the reverse schedule, written out in one autograd
  Function (``_Pipeline``): at step ``s`` from the last down, each stage
  runs the backward of its step-``s`` subgraph with the cotangent of its
  output (the last stage's from the outputs' gradient, as is: the sum
  that replicated them passes its cotangent through, as
  ``tensor.reduce_from_tp`` does; the others' from the stage after, by the
  reverse rotation), which puts its layers' gradients into their leaves
  and hands the input's cotangent back. Stage 0's input cotangents are
  the embedded batch's gradient, summed over pp so that every rank's
  embedding gets it (the head, the final norm and the value head read the
  replicated outputs and have their whole gradients on every rank
  already). Every rank steps through every exchange in the same order;
- a feed whose rows are not a multiple of the microbatches is padded with
  fully masked rows (no attention, no expert capacity) and sliced back;
- remat applies per layer inside the stage; the stage attention is the
  flash wrapper (K4 on the card, its plain version on the CPU) with the
  rows' segment ids (the validity mask's, when the rows are not packed),
  or with ``sp_ring`` the ring attention over this rank's ``T/sp``
  columns (``parallel/sequence.ring_attention_local``).

The bubble is the GPipe ``(pp-1)/(n+pp-1)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from polyrl_tpu_torch.models import decoder
from polyrl_tpu_torch.ops import flash
from polyrl_tpu_torch.parallel import expert, tensor
from polyrl_tpu_torch.parallel.mesh import PP, SP, Mesh, all_reduce, block, rotate


def stage_layers(mesh: Mesh, layers: dict) -> dict:
    """This rank's stage of a whole stacked layer tree (dim 0 of every
    leaf over pp; wrappers slice like tensors)."""
    out = {}
    for k, v in layers.items():
        if isinstance(v, torch.Tensor):
            out[k] = block(mesh, v, PP, 0)
        else:
            out[k] = v.rebuild({f: block(mesh, t, PP, 0)
                                for f, t in v.fields().items()})
    return out


class _Schedule:
    """One pass of the schedule over ``n`` microbatches: ``step(m, h)``
    runs this stage's layers on microbatch ``m``'s activations ``h``."""

    def __init__(self, mesh: Mesh, step, n: int):
        self.mesh, self.step, self.n = mesh, step, n
        self.pp = mesh.shape[PP]
        self.stage = mesh.coords[PP]
        self.saved: dict[int, tuple] = {}

    def _window(self, s: int) -> int | None:
        m = s - self.stage
        return m if 0 <= m < self.n else None

    def forward(self, xs: torch.Tensor, record: bool) -> torch.Tensor:
        """``xs`` [n, mb, t, d] -> the outputs [n, mb, t, d] on every
        rank; ``record`` keeps each step's subgraph for ``backward``."""
        steps = self.n + self.pp - 1
        outs = torch.zeros_like(xs)
        state = None
        for s in range(steps):
            m = self._window(s)
            if m is None:
                send = torch.zeros_like(xs[0])
            else:
                inp = xs[m] if self.stage == 0 else state
                if record:
                    inp = inp.detach().requires_grad_(True)
                    with torch.enable_grad():
                        h = self.step(m, inp)
                    self.saved[s] = (inp, h)
                else:
                    h = self.step(m, inp)
                send = h.detach()
                if self.stage == self.pp - 1:
                    outs[m] = send
            if s < steps - 1:
                state = rotate(self.mesh, PP, send.contiguous(), 1)
        return all_reduce(self.mesh, (PP,), outs)

    def backward(self, g: torch.Tensor) -> torch.Tensor:
        """The reverse schedule for the outputs' cotangent ``g`` (the
        same on every rank): the embedded batch's cotangent, summed over
        pp."""
        steps = self.n + self.pp - 1
        dxs = torch.zeros_like(g)
        recv = None
        for s in reversed(range(steps)):
            m = self._window(s)
            if m is None:
                send = torch.zeros_like(g[0])
            else:
                dh = g[m] if self.stage == self.pp - 1 else recv
                inp, h = self.saved.pop(s)
                torch.autograd.backward(h, dh)
                send = inp.grad
                if self.stage == 0:
                    dxs[m] = send
            if s > 0:
                recv = rotate(self.mesh, PP, send.contiguous(), -1)
        return all_reduce(self.mesh, (PP,), dxs)


class _Pipeline(torch.autograd.Function):
    """The schedule as one autograd node: ``anchor`` (an empty tensor that
    requires grad) makes the node record even when ``xs`` does not."""

    @staticmethod
    def forward(ctx, xs, anchor, sched):
        ctx.sched = sched
        return sched.forward(xs, record=True)

    @staticmethod
    def backward(ctx, g):
        dx = ctx.sched.backward(g.contiguous())
        ctx.sched = None
        return dx, None, None


def make_pipeline_layers_fn(mesh: Mesh, cfg, num_microbatches: int,
                            remat: bool = False, sp_ring: bool = False):
    """``layers_fn(layers, x, cos, sin, attn_mask, segment_ids=None)`` for
    ``decoder.forward_hidden``: ``layers`` this rank's stage (``L/pp``
    stacked layers, or a per-layer source of them), ``x`` [B, T, d] the
    embedded rows (this rank's ``T/sp`` columns with ``sp_ring``) ->
    [B, T, d] after every stage, on every rank. ``segment_ids`` [B, T]
    (0 = pad) makes the stages' attention block-diagonal within segments
    (packed rows).

    Requires ``cfg.num_layers % pp == 0``. On a tp or ep axis each stage
    runs its tensor- and expert-parallel shards (``decoder.layer_forward``
    with the mesh's seams)."""
    pp = mesh.shape[PP]
    n = int(num_microbatches)
    if cfg.num_layers % pp != 0:
        raise ValueError(f"num_layers {cfg.num_layers} not divisible by "
                         f"pp {pp}")
    if n < 1:
        raise ValueError(f"num_microbatches must be >= 1, got {n}")
    lpp = cfg.num_layers // pp
    tp = tensor.TensorParallel(mesh) if mesh.shape[tensor.TP] > 1 else None
    ep = expert.mesh_ep(mesh)
    ring = None
    if sp_ring:
        from polyrl_tpu_torch.parallel.sequence import make_ring_attention

        ring = make_ring_attention(mesh, SP, packed=True)

    def check_stage(layers) -> None:
        if isinstance(layers, dict):
            lead = {v.shape[0] for v in layers.values()
                    if isinstance(v, torch.Tensor) and v.dim()}
            if lead and lead != {lpp}:
                raise ValueError(f"a pipeline stage holds {lpp} layers; got "
                                 f"stacked leaves of {sorted(lead)} "
                                 "(pipeline.stage_layers cuts a whole tree)")

    def layers_fn(layers, x, cos, sin, attn_mask, segment_ids=None):
        check_stage(layers)
        b, t, d = x.shape
        b_pad = -(-b // n) * n
        seg = (segment_ids if segment_ids is not None
               else (attn_mask > 0).to(torch.int32))
        if b_pad != b:
            grow = b_pad - b

            def pad(a):
                return F.pad(a, (0, 0) * (a.dim() - 1) + (0, grow))

            x, cos, sin, attn_mask, seg = map(pad, (x, cos, sin, attn_mask, seg))
        mb = b_pad // n
        xs = x.reshape(n, mb, t, d)
        coss = cos.reshape(n, mb, *cos.shape[1:])
        sins = sin.reshape(n, mb, *sin.shape[1:])
        masks = attn_mask.reshape(n, mb, t)
        segs = seg.reshape(n, mb, t)

        def step(m, h):
            sg = segs[m]
            if ring is not None:
                attn = lambda q, k, v, am: ring(q, k, v, am, sg)  # noqa: E731
            else:
                attn = lambda q, k, v, am: flash.flash_attention_train(  # noqa: E731
                    q, k, v, am, causal=True, segment_ids=sg)
            return decoder.run_layers(cfg, layers, h, coss[m], sins[m], attn,
                                      masks[m], remat, tp, ep, count=lpp)

        sched = _Schedule(mesh, step, n)
        if torch.is_grad_enabled():
            anchor = torch.empty(0, device=x.device, requires_grad=True)
            outs = _Pipeline.apply(xs.contiguous(), anchor, sched)
        else:
            outs = sched.forward(xs.contiguous(), record=False)
        return outs.reshape(b_pad, t, d)[:b]

    return layers_fn
