"""The port's copies of the JAX package's host-side helpers, held against
the originals: tokenizer, metrics tracker, FLOPs counter, TensorBatch,
datasets, reward scorers and managers, and the config loader."""

import numpy as np
import pytest
import torch

from polyrl_tpu.data import batch as jbatch
from polyrl_tpu.data import dataset as jdata
from polyrl_tpu.models import decoder as jdec
from polyrl_tpu.rewards import manager as jman
from polyrl_tpu.rewards import scorers as jscore
from polyrl_tpu.utils import flops as jflops
from polyrl_tpu.utils import metrics as jmetrics
from polyrl_tpu.utils import tokenizer as jtok
from polyrl_tpu_torch import config as tconfig
from polyrl_tpu_torch.data import batch as tbatch
from polyrl_tpu_torch.data import dataset as tdata
from polyrl_tpu_torch.models import decoder as tdec
from polyrl_tpu_torch.rewards import manager as tman
from polyrl_tpu_torch.rewards import scorers as tscore
from polyrl_tpu_torch.utils import flops as tflops
from polyrl_tpu_torch.utils import metrics as tmetrics
from polyrl_tpu_torch.utils import tokenizer as ttok


def test_byte_tokenizer_matches():
    j, t = jtok.ByteTokenizer(), ttok.ByteTokenizer()
    text = "12+7=19 ✓ <x>"
    assert t.encode(text, add_bos=True, add_eos=True) == j.encode(
        text, add_bos=True, add_eos=True)
    ids = t.encode(text) + [256, 258, 300]
    for skip in (True, False):
        assert t.decode(ids, skip) == j.decode(ids, skip)
    assert (t.pad_token_id, t.eos_token_id, t.vocab_size) == (256, 258, 260)
    assert isinstance(ttok.load_tokenizer("byte"), ttok.ByteTokenizer)


def test_metrics_tracker_matches():
    recs = []
    for mod in (jmetrics, tmetrics):
        m = mod.MetricsTracker()
        m.update({"actor/pg_loss": 1.0})
        m.update({"actor/pg_loss": 3.0})
        m.update_gauge({"perf/x": 2.0})
        m.incr("gen/failed", 2)
        m.add_timing("gen", 0.5)
        for v in (0.1, 0.2, 0.4, 3.0):
            m.observe("lat", v)
        with pytest.raises(RuntimeError), mod.marked_timer("update_actor", m):
            raise RuntimeError("boom")
        recs.append(m.as_dict())
    assert recs[0].keys() == recs[1].keys()
    for k in recs[0]:
        if k == "timing_s/update_actor":  # a wall time
            continue
        assert recs[1][k] == pytest.approx(recs[0][k]), k
    assert recs[1]["update_actor/failed"] == 1.0
    m = tmetrics.MetricsTracker()
    m.update({"timing_s/gen": 1.0})
    m.add_timing("gen", 1.0)
    with pytest.raises(ValueError):  # collisions raise under pytest
        m.as_dict()


@pytest.mark.parametrize("preset", ["qwen3-1.7b", "llama3.2-1b", "qwen3-30b-a3b"])
def test_flops_match(preset):
    jc, tc = jdec.get_config(preset), tdec.get_config(preset)
    assert tflops.param_count(tc) == jflops.param_count(jc)
    for training in (True, False):
        assert tflops.flops_per_token(tc, 700.0, training=training) == \
            jflops.flops_per_token(jc, 700.0, training=training)
    tm = tflops.FlopsCounter(tc).step_metrics(8192, 512.0, 3.0)
    jm = jflops.FlopsCounter(jc, peak_tflops=989.0).step_metrics(8192, 512.0, 3.0)
    assert tm == pytest.approx(jm)
    assert tflops.FlopsCounter(tc).peak_tflops == 989.0


def test_tensor_batch_verbs_match():
    rng = np.random.default_rng(0)
    t = {"a": rng.standard_normal((6, 3)).astype(np.float32),
         "b": np.arange(6, dtype=np.int32)}
    nt = {"s": [f"r{i}" for i in range(6)]}
    jb = jbatch.TensorBatch.from_dict(t, nt, {"step": 1})
    tb = tbatch.TensorBatch.from_dict(t, nt, {"step": 1})

    def same(x, y):
        assert x.keys() == y.keys() and x.meta_info == y.meta_info
        for k in x.tensors:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))
        for k in x.non_tensors:
            assert list(x[k]) == list(y[k])

    for f in (lambda b: b.split(4)[1], lambda b: b.chunk(3)[2],
              lambda b: b.repeat(2, interleave=True),
              lambda b: b.repeat(2, interleave=False), lambda b: b[1:4],
              lambda b: b.select(["a"], ["s"]), lambda b: b.to_numpy()):
        same(f(jb), f(tb))
    same(jbatch.TensorBatch.concat(jb.split(2)), tbatch.TensorBatch.concat(tb.split(2)))
    tt = tbatch.TensorBatch.from_dict({"x": torch.arange(6)}, nt)
    assert torch.equal(tbatch.TensorBatch.concat(tt.split(4))["x"], torch.arange(6))
    assert torch.equal(tt[[1, 3]]["x"], torch.tensor([1, 3]))
    with pytest.raises(ValueError):
        tbatch.TensorBatch.from_dict({"x": np.zeros(3), "y": np.zeros(4)})


def test_datasets_and_loader_match():
    jd, td = jdata.make_arithmetic_dataset(32, seed=3), tdata.make_arithmetic_dataset(32, seed=3)
    assert jd.records == td.records
    jl, tl = jdata.PromptDataLoader(jd, 5, seed=1), tdata.PromptDataLoader(td, 5, seed=1)
    for _ in range(4):
        assert next(jl) == next(tl)
    assert tl.state_dict() == jl.state_dict()


@pytest.mark.parametrize("source,text,gt", [
    ("gsm8k", "so the answer is 42", "42"), ("math", "x = \\boxed{\\frac{1}{2}}", "0.5"),
    ("math_dapo", "\\boxed{7}", "8"), ("numina", "The answer is: 12", "12"),
    ("geometry3k", "<think>a</think> \\boxed{3}", "3"),
    ("searchr1", "<answer>The Eiffel Tower</answer>", "eiffel tower|||tour eiffel"),
    ("other", "17", "17")])
def test_scorers_match(source, text, gt):
    assert tscore.default_compute_score(source, text, gt) == \
        jscore.default_compute_score(source, text, gt)


@pytest.mark.parametrize("name", ["naive", "batch", "dapo", "prime"])
def test_reward_managers_match(name):
    rng = np.random.default_rng(1)
    b, tr = 6, 10
    resp = rng.integers(48, 58, (b, tr)).astype(np.int32)
    mask = np.zeros((b, tr), np.float32)
    for i in range(b):
        mask[i, : 1 + i] = 1
    tensors = {"responses": resp, "response_mask": mask}
    nt = {"ground_truth": ["1", "2", "3", "44", "5", "6"],
          "data_source": ["gsm8k"] * b}
    if name == "batch":
        def score(ds, texts, gts, ex):
            return [float(len(t)) for t in texts]
    else:
        def score(ds, txt, gt, ex):
            return float(gt in txt) + 0.1 * len(txt)
    kw = dict(max_response_length=tr, overlong_buffer_len=4) if name == "dapo" else {}
    outs = []
    for mod, bmod, tok in ((jman, jbatch, jtok.ByteTokenizer()),
                           (tman, tbatch, ttok.ByteTokenizer())):
        rm = mod.load_reward_manager(name, tok, compute_score=score, num_workers=2, **kw)
        outs.append(rm(bmod.TensorBatch.from_dict(tensors, nt)))
    np.testing.assert_allclose(outs[1].token_level_scores, outs[0].token_level_scores)
    np.testing.assert_allclose(outs[1].scores, outs[0].scores)
    assert outs[1].metrics == pytest.approx(outs[0].metrics)


def test_config_overrides_and_validation():
    cfg = tconfig.load_config(None, ["trainer.total_steps=3", "actor.lr=2e-5",
                                     "rollout.prompt_buckets=[64,128]",
                                     "model.overrides={\"num_layers\": 2}",
                                     "actor.use_kl_loss=true", "device=cpu"])
    assert cfg.trainer.total_steps == 3 and cfg.actor.lr == 2e-5
    assert cfg.rollout.prompt_buckets == (64, 128) and cfg.actor.use_kl_loss
    assert cfg.model.overrides == {"num_layers": 2} and cfg.device == "cpu"
    assert tconfig.to_dict(cfg)["rollout"]["prompt_buckets"] == [64, 128]
    with pytest.raises(KeyError):
        tconfig.load_config(None, ["trainer.bogus=1"])
    with pytest.raises(ValueError):
        tconfig.load_config(None, ["trainer.rollout_n=3"])
    with pytest.raises(KeyError):
        tconfig._build(tconfig.RunConfig, {"parallel": {}})
    built = tconfig._build(tconfig.RunConfig, {"trainer": {"total_steps": 5},
                                               "rollout": {"prompt_buckets": [32]}})
    assert built.trainer.total_steps == 5 and built.rollout.prompt_buckets == (32,)
