"""RL prompt datasets and samplers (a copy of
``polyrl_tpu/data/dataset.py``).

Sources: in-memory records, JSONL, or parquet (via pyarrow when present).
Each record carries ``prompt``, ``ground_truth``, ``data_source`` and an
optional ``extra_info``: the fields the reward layer dispatches on.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass
from typing import Iterator, Sequence


@dataclass
class RLDataset:
    records: list[dict]

    @classmethod
    def from_jsonl(cls, path: str) -> "RLDataset":
        with open(path) as f:
            return cls([json.loads(line) for line in f if line.strip()])

    @classmethod
    def from_parquet(cls, path: str, prompt_key: str = "prompt") -> "RLDataset":
        import pyarrow.parquet as pq  # optional dep, present with pandas stacks

        records = pq.read_table(path).to_pylist()
        for r in records:
            if prompt_key != "prompt":
                r["prompt"] = r.get(prompt_key, r.get("prompt", ""))
            # preprocess scripts store extra_info as a JSON string to keep
            # the parquet schema flat; decode back to a dict
            if isinstance(r.get("extra_info"), str):
                try:
                    r["extra_info"] = json.loads(r["extra_info"])
                except ValueError:
                    pass
        return cls(records)

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, i: int) -> dict:
        return self.records[i]


def make_sampler(n: int, kind: str = "random", seed: int = 0,
                 scores: Sequence[float] | None = None) -> Iterator[int]:
    """random | sequential | curriculum index stream (reference
    create_rl_sampler, main_ppo.py:398-439). Curriculum orders by
    ``scores`` ascending (easy→hard) on the first epoch, then anneals to
    random shuffles — the reference's curriculum sampler contract."""
    rng = random.Random(seed)
    first = True
    while True:
        order = list(range(n))
        if kind == "curriculum" and scores is not None and first:
            order.sort(key=lambda i: scores[i])
        elif kind in ("random", "curriculum"):
            rng.shuffle(order)
        first = False
        yield from order


class PromptDataLoader:
    """Batches of raw records; stateful for checkpoint/resume (the reference
    uses StatefulDataLoader, stream_ray_trainer.py:38)."""

    def __init__(self, dataset: RLDataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, sampler_kind: str | None = None,
                 curriculum_key: str = "difficulty"):
        self.dataset = dataset
        self.batch_size = batch_size
        kind = sampler_kind or ("random" if shuffle else "sequential")
        scores = None
        if kind == "curriculum":
            scores = [float((r.get("extra_info") or {}).get(curriculum_key, 0.0))
                      for r in dataset.records]
        self.sampler = make_sampler(len(dataset), kind, seed, scores=scores)
        self.consumed = 0

    def state_dict(self) -> dict:
        return {"consumed": self.consumed}

    def load_state_dict(self, state: dict) -> None:
        for _ in range(state["consumed"]):
            next(self.sampler)
        self.consumed = state["consumed"]

    def __iter__(self):
        return self

    def __next__(self) -> list[dict]:
        batch = [self.dataset[next(self.sampler)] for _ in range(self.batch_size)]
        self.consumed += self.batch_size
        return batch


# -- synthetic arithmetic task for e2e tests/benchmarks ---------------------


def make_arithmetic_dataset(n: int = 512, seed: int = 0, lo: int = 0, hi: int = 20) -> RLDataset:
    """Tiny addition task: trainable end-to-end with the ByteTokenizer.
    Serves the role of GSM8K in environments with no dataset downloads."""
    rng = random.Random(seed)
    records = []
    for _ in range(n):
        a, b = rng.randint(lo, hi), rng.randint(lo, hi)
        records.append(
            {
                "prompt": f"{a}+{b}=",
                "ground_truth": str(a + b),
                "data_source": "gsm8k",  # routes to the gsm8k scorer (flexible)
            }
        )
    return RLDataset(records)
