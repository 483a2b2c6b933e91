"""The step backend on the CPU: the port's ``RolloutEngine`` and
``StepDecoder`` against the JAX package's, on ``tiny`` in f32 with the
JAX weights carried across through numpy.

Each test of ``tests/test_rollout_engine.py`` has its counterpart here;
then greedy parity with the JAX ``RolloutEngine`` (tokens equal, logprobs
within 5e-4, the bound of the port's other engine tests) and the stepper's
stream against ``generate``, with an abort mid-stream.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyrl_tpu.models import decoder as jdec
from polyrl_tpu.rollout.engine import RolloutEngine as JEngine
from polyrl_tpu.rollout.sampling import SamplingParams as JSP
from polyrl_tpu_torch.models import decoder
from polyrl_tpu_torch.models.convert import params_from_numpy
from polyrl_tpu_torch.rollout.engine import (
    GenerationOutput,
    RolloutEngine,
    next_bucket,
    pack_left_padded,
)
from polyrl_tpu_torch.rollout.sampling import (
    SamplingParams,
    apply_top_k,
    apply_top_p,
    sample_token,
)
from polyrl_tpu_torch.rollout.stepper import StepDecoder

LP_TOL = 5e-4
GEOM = dict(batch_buckets=(4, 8), prompt_buckets=(16, 32))


def _jtree(seed):
    cfg = jdec.get_config("tiny", dtype=jnp.float32)
    return jax.tree_util.tree_map(
        np.asarray, jdec.init_params(jax.random.PRNGKey(seed), cfg))


def _engine(tree, **kw):
    cfg = decoder.get_config("tiny", dtype=torch.float32)
    return RolloutEngine(cfg, params_from_numpy(tree, "cpu", torch.float32),
                         pad_token_id=0, kv_cache_dtype=torch.float32,
                         device="cpu", **{**GEOM, **kw})


@pytest.fixture(scope="module")
def tree():
    return _jtree(0)


@pytest.fixture(scope="module")
def engine(tree):
    return _engine(tree)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_next_bucket():
    assert next_bucket(3, (4, 8)) == 4
    assert next_bucket(5, (4, 8)) == 8
    with pytest.raises(ValueError):
        next_bucket(9, (4, 8))


def test_generate_basic(engine):
    prompts = [[5, 6, 7], [9, 10, 11, 12, 13]]
    sp = SamplingParams(temperature=1.0, max_new_tokens=8)
    outs = engine.generate(prompts, sp, rng=_gen(0))
    assert len(outs) == 2
    for o, p in zip(outs, prompts):
        assert isinstance(o, GenerationOutput)
        assert o.prompt_tokens == len(p)
        assert 1 <= o.completion_tokens <= 8
        assert o.output_ids.shape == o.output_token_logprobs.shape
        assert o.finish_reason in ("stop", "length")
        assert (o.output_token_logprobs <= 0).all()
        assert o.output_token_weight_versions == [engine.weight_version] * len(
            o.output_ids)


def test_generate_greedy_deterministic(engine):
    prompts = [[5, 6, 7]]
    sp = SamplingParams(temperature=0.0, max_new_tokens=6)
    a = engine.generate(prompts, sp, rng=_gen(0))[0]
    b = engine.generate(prompts, sp, rng=_gen(42))[0]
    np.testing.assert_array_equal(a.output_ids, b.output_ids)


def test_stop_token_truncates(engine):
    prompts = [[1, 2]]
    sp = SamplingParams(temperature=0.0, max_new_tokens=6, stop_token_ids=())
    greedy = engine.generate(prompts, sp, rng=_gen(0))[0]
    first = int(greedy.output_ids[0])
    sp2 = SamplingParams(temperature=0.0, max_new_tokens=6,
                         stop_token_ids=(first,))
    out = engine.generate(prompts, sp2, rng=_gen(0))[0]
    assert out.finish_reason == "stop"
    assert out.completion_tokens == 1
    assert int(out.output_ids[0]) == first


def test_greedy_logprob_matches_forward(engine):
    """Engine logprobs equal a fresh teacher-forced full forward."""
    prompts = [[3, 4, 5, 6]]
    sp = SamplingParams(temperature=0.0, max_new_tokens=4)
    out = engine.generate(prompts, sp, rng=_gen(1))[0]
    full = np.concatenate([prompts[0], out.output_ids])
    ids = torch.as_tensor(full[None, :], dtype=torch.long)
    pos = torch.arange(ids.shape[1])[None]
    with torch.no_grad():
        logits, _ = decoder.forward(engine.params, engine.cfg, ids, pos,
                                    torch.ones(ids.shape))
    logp = torch.log_softmax(logits.double(), dim=-1).numpy()
    for j, tok in enumerate(out.output_ids):
        expect = logp[0, len(prompts[0]) - 1 + j, int(tok)]
        assert abs(expect - out.output_token_logprobs[j]) < 1e-3


def test_update_weights_changes_output(engine, tree):
    prompts = [[7, 8, 9]]
    sp = SamplingParams(temperature=0.0, max_new_tokens=4)
    before = engine.generate(prompts, sp, rng=_gen(0))[0]
    old_version = engine.weight_version
    engine.update_weights(params_from_numpy(_jtree(123), "cpu", torch.float32))
    assert engine.weight_version == old_version + 1
    after = engine.generate(prompts, sp, rng=_gen(0))[0]
    assert after.output_token_weight_versions == [old_version + 1] * 4
    engine.update_weights(params_from_numpy(tree, "cpu", torch.float32),
                          version=old_version)
    restored = engine.generate(prompts, sp, rng=_gen(0))[0]
    np.testing.assert_array_equal(before.output_ids, restored.output_ids)
    bad = params_from_numpy(tree, "cpu", torch.float64)
    with pytest.raises(ValueError, match="update_weights"):
        engine.update_weights(bad)
    assert engine.weight_version == old_version


def test_sampling_top_k():
    logits = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    masked = apply_top_k(logits, 2).numpy()
    assert (masked[0, :2] < -1e30).all()
    np.testing.assert_array_equal(masked[0, 2:], [3.0, 4.0])


def test_sampling_top_p():
    # probs .644 .236 .087 .032: top_p=0.7 keeps the first two
    logits = torch.tensor([[4.0, 3.0, 2.0, 1.0]])
    m = apply_top_p(logits, 0.7).numpy()[0]
    assert m[0] == 4.0 and m[1] == 3.0
    assert (m[2:] < -1e30).all()
    m1 = apply_top_p(logits, 1e-9).numpy()[0]  # the top-1 always stays
    assert m1[0] == 4.0 and (m1[1:] < -1e30).all()


def test_sample_token_greedy_logprob():
    logits = torch.tensor([[0.0, float(np.log(3.0))]])  # probs .25 / .75
    tok, lp = sample_token(logits, _gen(0), SamplingParams(temperature=0.0))
    assert int(tok[0]) == 1
    assert abs(float(lp[0]) - float(np.log(0.75))) < 1e-6


def test_pack_left_padded_matches_jax():
    from polyrl_tpu.rollout.engine import pack_left_padded as jpack

    prompts = [[5, 6, 7], [1], [2, 3, 4, 5, 6]]
    for got, want in zip(pack_left_padded(prompts, 0, 4, 8),
                         jpack(prompts, 0, 4, 8)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stop", [False, True], ids=["length", "stop"])
def test_greedy_parity_with_jax_rollout_engine(tree, stop):
    """The same greedy tokens as the JAX RolloutEngine, logprobs within
    5e-4, over a left-padded batch of mixed prompt lengths (with a stop
    token that ends some rows early, the early exit included)."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 256, n).tolist() for n in (3, 9, 14, 5, 16)]
    jeng = JEngine(jdec.get_config("tiny", dtype=jnp.float32),
                   jax.tree_util.tree_map(jnp.asarray, tree), pad_token_id=0,
                   kv_cache_dtype=jnp.float32, **GEOM)
    probe = jeng.generate(prompts, JSP(temperature=0.0, max_new_tokens=20),
                          rng=jax.random.PRNGKey(0))
    stops = (int(probe[1].output_ids[4]),) if stop else ()
    ref = jeng.generate(prompts, JSP(temperature=0.0, max_new_tokens=20,
                                     stop_token_ids=stops),
                        rng=jax.random.PRNGKey(0))
    eng = _engine(tree)
    out = eng.generate(prompts, SamplingParams(temperature=0.0,
                                               max_new_tokens=20,
                                               stop_token_ids=stops))
    if stop:
        assert any(o.finish_reason == "stop" for o in ref)
    for t, j in zip(out, ref):
        assert t.output_ids.tolist() == np.asarray(j.output_ids).tolist()
        assert t.finish_reason == j.finish_reason
        np.testing.assert_allclose(t.output_token_logprobs,
                                   np.asarray(j.output_token_logprobs),
                                   rtol=0, atol=LP_TOL)


def test_stepper_stream_matches_generate_and_aborts(engine):
    """``generate_stream`` streams the same greedy tokens and logprobs as
    ``generate`` (per-row budgets honoured); a row whose abort event is set
    mid-stream yields one token-less ``abort`` line and nothing after."""
    prompts = [[5, 6, 7], [9, 10, 11, 12], [2, 3]]
    limits = [12, 7, 12]
    sp = SamplingParams(temperature=0.0, max_new_tokens=12)
    want = engine.generate(prompts, sp)
    stepper = StepDecoder(engine)
    flags = [threading.Event() for _ in prompts]
    rows = {i: [] for i in range(len(prompts))}
    ends = {}
    for ev in stepper.generate_stream(prompts, sp, max_new=limits,
                                      abort_flags=flags):
        i = ev["row"]
        assert i not in ends, "a row streamed after its end"
        if ev["token"] is not None:
            rows[i].append((ev["token"], ev["logprob"]))
        if ev["done"]:
            ends[i] = ev["finish_reason"]
        if i == 2 and len(rows[2]) == 4:
            flags[2].set()
    assert ends == {0: "length", 1: "length", 2: "abort"}
    assert [t for t, _ in rows[0]] == want[0].output_ids.tolist()
    assert [t for t, _ in rows[1]] == want[1].output_ids[:7].tolist()
    assert [t for t, _ in rows[2]] == want[2].output_ids[:4].tolist()
    np.testing.assert_allclose([lp for _, lp in rows[0]],
                               want[0].output_token_logprobs, rtol=0, atol=1e-5)


def test_step_engine_refuses_missing_cuda(tree):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = decoder.get_config("tiny", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        RolloutEngine(cfg, params_from_numpy(tree, "cpu", torch.float32))
