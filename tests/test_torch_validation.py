"""Validation in the port's trainer on the CPU (torch copies of the JAX
package's validation tests): greedy evaluation on the colocated engine,
per-source aggregation, the generation dump, the ``test_freq`` and
``val_before_train`` gates, and repeatability on the same weights."""

import json
import os

import torch

from polyrl_tpu_torch.config import load_config
from polyrl_tpu_torch.data.dataset import (PromptDataLoader, RLDataset,
                                           make_arithmetic_dataset)
from polyrl_tpu_torch.models import decoder
from polyrl_tpu_torch.rewards.manager import load_reward_manager
from polyrl_tpu_torch.rollout.cb_engine import CBEngine
from polyrl_tpu_torch.train import build_dataset
from polyrl_tpu_torch.trainer.actor import ActorConfig, StreamActor
from polyrl_tpu_torch.trainer.stream_trainer import StreamRLTrainer, TrainerConfig
from polyrl_tpu_torch.utils.tokenizer import ByteTokenizer

VAL_RECORDS = [
    {"prompt": "1+1=", "ground_truth": "2", "data_source": "gsm8k"},
    {"prompt": "2+2=", "ground_truth": "4", "data_source": "gsm8k"},
    {"prompt": "q?", "ground_truth": "x", "data_source": "other"},
]


def _make(tmp_path, *, total_steps=2, test_freq=1, val_before=True, dump=True):
    cfg = decoder.get_config("tiny", dtype=torch.float32, vocab_size=512,
                             max_position_embeddings=128)
    params = decoder.init_params(torch.Generator().manual_seed(0), cfg)
    tok = ByteTokenizer()
    engine = CBEngine(cfg, params, pad_token_id=tok.pad_token_id, max_slots=8,
                      page_size=8, max_seq_len=32, prompt_buckets=(16,),
                      num_pages=64, kv_cache_dtype=torch.float32, device="cpu")
    tcfg = TrainerConfig(
        train_batch_size=4, rollout_n=2, ppo_mini_batch_size=8,
        micro_batch_size=4, min_stream_batch_size=4,
        max_prompt_length=16, max_response_length=8,
        adv_estimator="grpo", total_steps=total_steps,
        test_freq=test_freq, val_before_train=val_before,
        rollout_data_dir=str(tmp_path / "dump") if dump else "")
    actor = StreamActor(cfg, ActorConfig(lr=1e-4, remat=False), params)
    trainer = StreamRLTrainer(
        tcfg, actor, engine, tok,
        load_reward_manager("naive", tok, num_workers=1),
        PromptDataLoader(make_arithmetic_dataset(32), 4),
        val_dataset=RLDataset(list(VAL_RECORDS)))
    return trainer, engine


def test_validation_runs_and_aggregates(tmp_path):
    trainer, engine = _make(tmp_path)
    try:
        history = trainer.fit()
    finally:
        engine.stop()
    # val_before_train adds a record before the first step
    assert "val/test_score/mean" in history[0]
    assert "timing_s/testing" in history[0]
    assert "val/test_score/gsm8k" in history[0]
    assert "val/test_score/other" in history[0]
    # test_freq=1: validated after both steps too
    assert "val/test_score/mean" in history[1]
    assert "val/test_score/mean" in history[2]
    dumps = sorted(os.listdir(tmp_path / "dump"))
    assert dumps == ["val_step0.jsonl", "val_step1.jsonl", "val_step2.jsonl"]
    with open(tmp_path / "dump" / "val_step1.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 3
    assert {"step", "prompt", "response", "score", "ground_truth",
            "data_source"} <= set(rows[0])


def test_validation_gating_off(tmp_path):
    trainer, engine = _make(tmp_path, test_freq=0, val_before=False, dump=False,
                            total_steps=1)
    try:
        history = trainer.fit()
    finally:
        engine.stop()
    # only the validation forced at the last step runs
    assert len(history) == 1
    assert "val/test_score/mean" in history[0]


def test_no_val_dataset_no_validation(tmp_path):
    trainer, engine = _make(tmp_path, total_steps=1)
    trainer.val_dataset = None
    try:
        history = trainer.fit()
    finally:
        engine.stop()
    assert all("val/test_score/mean" not in h for h in history)


def test_val_greedy_deterministic(tmp_path):
    trainer, engine = _make(tmp_path, dump=False)
    try:
        m1 = trainer._validate()
        m2 = trainer._validate()
    finally:
        engine.stop()
    assert m1 == m2


def test_val_generations_logged(tmp_path):
    """``val_generations_to_log`` echoes the first K generations' scores
    to the logger, at the step they were validated at."""
    trainer, engine = _make(tmp_path, dump=False)
    logged = []

    class Logger:
        def log(self, record, step):
            logged.append((step, record))

    trainer.logger = Logger()
    trainer.cfg.val_generations_to_log = 2
    try:
        trainer._validate()
    finally:
        engine.stop()
    assert len(logged) == 2
    assert all(step == 0 and set(rec) == {"val/generation", "score"}
               for step, rec in logged)


def test_build_dataset_val_split(tmp_path):
    """``data.val_path`` names the validation set; empty means none."""
    path = tmp_path / "val.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in VAL_RECORDS))
    cfg = load_config(None, ["device=cpu", f"data.val_path={path}"])
    assert build_dataset(cfg, "val").records == VAL_RECORDS
    assert build_dataset(load_config(None, ["device=cpu"]), "val") is None
