"""The port's sandbox-service client (``polyrl_tpu_torch/rewards/
sandbox.py``) against the JAX package's: ``tests/test_rewards.py``'s
sandbox cases (a stub service that runs the code, a dead URL with and
without the local fallback, HTTP 500, the concurrency bound) through both
clients, with equal results, scores and counters; a code-scoring batch
through both reward managers on the service; and ``build_trainer`` taking
the client from ``reward.sandbox_url``.
"""

import concurrent.futures

import numpy as np
import pytest

from polyrl_tpu.data.batch import TensorBatch as JTensorBatch
from polyrl_tpu.rewards.manager import load_reward_manager as j_load_rm
from polyrl_tpu.rewards.sandbox import SandboxClient as JSandboxClient
from polyrl_tpu.utils.tokenizer import ByteTokenizer as JByteTokenizer
from polyrl_tpu_torch import train
from polyrl_tpu_torch.config import load_config
from polyrl_tpu_torch.data.batch import TensorBatch
from polyrl_tpu_torch.rewards.manager import load_reward_manager
from polyrl_tpu_torch.rewards.sandbox import SandboxClient
from polyrl_tpu_torch.utils.tokenizer import ByteTokenizer
from tests.test_rewards import _FakeSandboxService

CLIENTS = {"torch": SandboxClient, "jax": JSandboxClient}
DEAD_URL = "http://127.0.0.1:9"  # nothing listens: every request fails

_CODE_SCORE = ("codecontests", "```python\nprint(int(input())*2)\n```", "",
               {"test_cases": {"inputs": ["4\n", "5\n"],
                               "outputs": ["8", "11"]}})


@pytest.fixture
def service():
    svc = _FakeSandboxService()
    yield svc
    svc.stop()


def _remote_case(cls, url):
    client = cls(url, max_concurrent=4, timeout_s=10.0)
    runs = [client.run("print(6*7)"), client.run("raise SystemExit(3)")]
    score = client.compute_score(*_CODE_SCORE)
    return runs, score, client.stats()


def test_remote_run_and_score_agree(service):
    ours = _remote_case(SandboxClient, service.url)
    assert ours == _remote_case(JSandboxClient, service.url)
    runs, score, stats = ours
    assert runs[0][0] and runs[0][1].strip() == "42"
    assert not runs[1][0]  # a failing program is a score, not a fallback
    assert score == 0.5
    assert stats == {"remote_runs": 4, "remote_failures": 0,
                     "local_fallbacks": 0}
    assert service.calls == 8


@pytest.mark.parametrize("fallback", [True, False],
                         ids=["fallback", "strict"])
def test_dead_service_agrees(fallback):
    got = {}
    for pkg, cls in CLIENTS.items():
        client = cls(DEAD_URL, max_concurrent=2, timeout_s=5.0,
                     fallback_local=fallback)
        ok, out = client.run("print('via-local')")
        got[pkg] = (ok, out.split(":")[0], client.stats())
    assert got["torch"] == got["jax"]
    ok, out, stats = got["torch"]
    if fallback:
        assert ok and out.strip() == "via-local"
        assert stats["remote_failures"] == 1 and stats["local_fallbacks"] == 1
    else:
        assert not ok and out == "sandbox service error"
        assert stats["remote_failures"] == 1 and stats["local_fallbacks"] == 0


def test_http_error_falls_back_in_both():
    svc = _FakeSandboxService(fail_mode="http500")
    try:
        got = {}
        for pkg, cls in CLIENTS.items():
            client = cls(svc.url, timeout_s=5.0)
            got[pkg] = (client.run("print('recovered')"),
                        client.compute_score(*_CODE_SCORE), client.stats())
    finally:
        svc.stop()
    assert got["torch"] == got["jax"]
    (ok, out), score, stats = got["torch"]
    assert ok and out.strip() == "recovered"
    assert score == 0.5 and stats["local_fallbacks"] == 3


def test_concurrency_is_bounded(service):
    client = SandboxClient(service.url, max_concurrent=2, timeout_s=15.0)
    code = "import time; time.sleep(0.2); print('ok')"
    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        results = list(ex.map(lambda _: client.run(code), range(8)))
    assert all(ok for ok, _ in results)
    assert service.max_inflight <= 2, service.max_inflight


def test_reward_managers_score_code_through_the_service(service):
    """A batch of code responses scored by each package's naive reward
    manager with its sandbox client: equal token-level scores."""
    responses = ["```python\nprint(int(input())*2)\n```",
                 "```python\nprint(int(input())+4)\n```",
                 "no code here"]
    gt = {"inputs": ["4\n", "5\n"], "outputs": ["8", "10"]}
    out = {}
    for pkg in ("torch", "jax"):
        tok = ByteTokenizer() if pkg == "torch" else JByteTokenizer()
        ids = [tok.encode(r) for r in responses]
        width = max(len(i) for i in ids)
        resp = np.full((len(ids), width), tok.pad_token_id, np.int32)
        mask = np.zeros((len(ids), width), np.int32)
        for i, row in enumerate(ids):
            resp[i, :len(row)] = row
            mask[i, :len(row)] = 1
        client = CLIENTS[pkg](service.url, max_concurrent=4, timeout_s=10.0)
        load = load_reward_manager if pkg == "torch" else j_load_rm
        batch_cls = TensorBatch if pkg == "torch" else JTensorBatch
        rm = load("naive", tok, compute_score=client.compute_score,
                  num_workers=2)
        batch = batch_cls(
            {"responses": resp, "response_mask": mask},
            {"data_source": np.array(["codecontests"] * 3, dtype=object),
             "ground_truth": np.array([""] * 3, dtype=object),
             "extra_info": np.array([{"test_cases": gt}] * 3, dtype=object)})
        res = rm(batch)
        out[pkg] = (np.asarray(res.scores), np.asarray(res.token_level_scores),
                    client.stats()["remote_runs"])
    np.testing.assert_array_equal(out["torch"][0], out["jax"][0])
    np.testing.assert_array_equal(out["torch"][1], out["jax"][1])
    assert out["torch"][0].tolist() == [1.0, 0.5, 0.0]
    assert out["torch"][2] == out["jax"][2] > 0


@pytest.mark.parametrize("url", ["", "http://127.0.0.1:9"],
                         ids=["local", "service"])
def test_build_trainer_takes_the_client_from_the_config(url):
    cfg = load_config(None, [
        "device=cpu", "model.preset=tiny", "model.dtype=float32",
        "rollout.max_slots=4", "rollout.page_size=8", "rollout.num_pages=32",
        "rollout.max_seq_len=64", "rollout.prompt_buckets=[16]",
        f"reward.sandbox_url={url}", "reward.sandbox_max_concurrent=3",
        "reward.sandbox_timeout_s=7.5", "reward.sandbox_memory_limit_mb=512",
        "trainer.train_batch_size=2", "trainer.rollout_n=2",
        "trainer.ppo_mini_batch_size=4", "trainer.micro_batch_size=2",
        "trainer.min_stream_batch_size=2", "trainer.max_prompt_length=16",
        "trainer.max_response_length=8", "data.arithmetic_size=8",
        "obs.statusz=false"])
    cleanup: list = []
    try:
        trainer = train.build_trainer(cfg, cleanup)
        score = trainer.reward_manager.compute_score
        if not url:
            assert not isinstance(getattr(score, "__self__", None),
                                  SandboxClient)
            return
        client = score.__self__
        assert isinstance(client, SandboxClient)
        assert (client.url, client.timeout_s, client.memory_limit_mb) == (
            url, 7.5, 512)
        assert client._sem._value == 3
        # a custom score wins over the service
        custom = train.build_trainer(cfg, cleanup,
                                     compute_score=lambda *a: 0.0)
        assert not isinstance(getattr(
            custom.reward_manager.compute_score, "__self__", None),
            SandboxClient)
    finally:
        for fn in reversed(cleanup):
            fn()
