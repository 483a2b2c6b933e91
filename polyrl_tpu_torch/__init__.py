"""PyTorch/CUDA port of ``polyrl_tpu`` for NVIDIA Hopper (H100).

The package mirrors ``polyrl_tpu``'s module paths so each counterpart is
easy to find, but it is self-contained: it imports ``torch`` and numpy,
never ``jax`` and never a module of ``polyrl_tpu``. The decode hot path
(paged K/V write, paged and grouped decode attention) and the training
attention (flash attention, forward and backward) run through CUDA
kernels written by hand for ``sm_90a`` (``polyrl_tpu_torch/csrc``), built
with ``nvcc`` at first use. ``python -m polyrl_tpu_torch.train`` runs the
colocated GRPO trainer; ``python -m polyrl_tpu_torch.rollout.serve`` the
rollout server.

Entry points take a ``device`` argument that defaults to ``"cuda"`` and
raise when CUDA is absent; only an explicit ``device="cpu"`` runs on the
CPU, where every kernel wrapper uses its plain PyTorch version.
"""

__version__ = "0.1.0"
