"""Packed-sequence (remove-padding) training support (a copy of
``polyrl_tpu/data/packing.py``, numpy only).

Trajectories are packed into a FIXED ``[n_rows, pack_len]`` grid with
segment ids (K4, the training flash attention, takes them:
``ops/flash.py``), in micro-batches of that fixed shape, instead of
``[B, Tp+Tr]`` padded rows whose pads take most of the FLOPs when
response lengths vary. A micro's token budget is ``n_rows * pack_len``;
bins are filled greedily in stream order, so group boundaries (GRPO) stay
intact across micros.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from polyrl_tpu_torch.data.batch import TensorBatch


@dataclasses.dataclass
class PackSpec:
    """Where each packed trajectory's RESPONSE tokens live.

    Arrays are aligned per-trajectory: trajectory ``orig_idx[j]`` of the
    source batch sits in packed row ``row[j]``; its response tokens occupy
    columns ``[resp_start[j], resp_start[j] + resp_len[j])``.
    """

    orig_idx: np.ndarray
    row: np.ndarray
    resp_start: np.ndarray
    resp_len: np.ndarray
    n_rows: int
    pack_len: int

    def scatter(self, field: np.ndarray, dtype=None) -> np.ndarray:
        """[B, Tr] padded per-response-token field -> packed [R, L]."""
        out = np.zeros((self.n_rows, self.pack_len),
                       dtype or np.asarray(field).dtype)
        for j in range(len(self.orig_idx)):
            n = self.resp_len[j]
            out[self.row[j], self.resp_start[j]:self.resp_start[j] + n] = \
                field[self.orig_idx[j], :n]
        return out

    def gather(self, packed: np.ndarray, t_resp: int) -> np.ndarray:
        """Packed [R, L] per-token field -> padded [B_src, Tr] (rows not in
        this pack stay zero; caller accumulates across packs)."""
        b = int(self.orig_idx.max()) + 1 if len(self.orig_idx) else 0
        out = np.zeros((b, t_resp), np.asarray(packed).dtype)
        self.gather_into(packed, out)
        return out

    def gather_into(self, packed: np.ndarray, out: np.ndarray) -> None:
        packed = np.asarray(packed)
        for j in range(len(self.orig_idx)):
            n = self.resp_len[j]
            out[self.orig_idx[j], :n] = \
                packed[self.row[j], self.resp_start[j]:self.resp_start[j] + n]


def _trajectory_tokens(batch: TensorBatch, t_prompt: int):
    """Per-trajectory (prompt_tokens, response_tokens) from the padded
    layout: prompts left-padded in input_ids[:, :Tp], responses right-padded
    in responses/response_mask."""
    input_ids = np.asarray(batch["input_ids"])
    attn = np.asarray(batch["attention_mask"])
    responses = np.asarray(batch["responses"])
    resp_mask = np.asarray(batch["response_mask"])
    prompts, resps = [], []
    for i in range(len(input_ids)):
        p = input_ids[i, :t_prompt][attn[i, :t_prompt] > 0]
        n = int(resp_mask[i].sum())
        prompts.append(p)
        resps.append(responses[i, :n])
    return prompts, resps


def iter_packed_micros(
    batch: TensorBatch,
    t_prompt: int,
    pack_len: int,
    n_rows: int,
    pad_id: int,
    scatter_keys: tuple[str, ...] = (),
):
    """Yield ``(packed TensorBatch, PackSpec)`` micro-batches of fixed shape
    [n_rows, pack_len], greedily filling bins IN STREAM ORDER (trajectories
    are never reordered, so GRPO groups stay contiguous and minibatch
    boundaries remain meaningful).

    Packed tensors: input_ids, positions (restart per segment), segment_ids
    (1-based, 0 = pad), attention_mask (validity), loss_mask (response
    tokens — the packed response_mask), plus ``scatter_keys`` ([B, Tr]
    per-response-token fields scattered into the packed layout).
    """
    prompts, resps = _trajectory_tokens(batch, t_prompt)
    n = len(prompts)
    i = 0
    while i < n:
        # fill up to n_rows bins first-fit in order
        fill = np.zeros(n_rows, np.int64)
        segs = [[] for _ in range(n_rows)]  # (traj_idx, start, p_len, r_len)
        placed_any = False
        while i < n:
            need = len(prompts[i]) + len(resps[i])
            if need > pack_len:
                raise ValueError(
                    f"trajectory {i} length {need} exceeds pack_len {pack_len}")
            fits = np.flatnonzero(fill + need <= pack_len)
            if len(fits) == 0:
                break
            r = int(fits[0])
            segs[r].append((i, int(fill[r]), len(prompts[i]), len(resps[i])))
            fill[r] += need
            placed_any = True
            i += 1
        if not placed_any:
            raise AssertionError("packing made no progress")
        yield _build_pack(batch, prompts, resps, segs, pack_len, n_rows,
                          pad_id, scatter_keys)


def _build_pack(batch, prompts, resps, segs, pack_len, n_rows, pad_id,
                scatter_keys):
    input_ids = np.full((n_rows, pack_len), pad_id, np.int32)
    positions = np.zeros((n_rows, pack_len), np.int32)
    segment_ids = np.zeros((n_rows, pack_len), np.int32)
    loss_mask = np.zeros((n_rows, pack_len), np.float32)
    oi, rw, rs, rl = [], [], [], []
    for r in range(n_rows):
        for s_idx, (ti, start, p_len, r_len) in enumerate(segs[r]):
            tot = p_len + r_len
            input_ids[r, start:start + p_len] = prompts[ti]
            input_ids[r, start + p_len:start + tot] = resps[ti]
            positions[r, start:start + tot] = np.arange(tot)
            segment_ids[r, start:start + tot] = s_idx + 1
            loss_mask[r, start + p_len:start + tot] = 1.0
            oi.append(ti)
            rw.append(r)
            rs.append(start + p_len)
            rl.append(r_len)
    spec = PackSpec(np.asarray(oi), np.asarray(rw), np.asarray(rs),
                    np.asarray(rl), n_rows, pack_len)
    tensors = {
        "input_ids": input_ids,
        "positions": positions,
        "segment_ids": segment_ids,
        "attention_mask": (segment_ids > 0).astype(np.float32),
        "loss_mask": loss_mask,
    }
    for k in scatter_keys:
        tensors[k] = spec.scatter(np.asarray(batch[k]))
    return TensorBatch.from_dict(tensors=tensors), spec


def packing_efficiency(specs: list[PackSpec], prompts_resps_tokens: int,
                       n_rows: int, pack_len: int) -> float:
    """real tokens / padded grid capacity across all packs."""
    cap = sum(1 for _ in specs) * n_rows * pack_len
    return prompts_resps_tokens / cap if cap else 0.0
