"""The port stands alone: ``polyrl_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package, nor ``safetensors`` or
``transformers``, which the card's image lacks (the port reads
safetensors itself; the one exception is ``utils/tokenizer.py``'s guarded
import of a Hugging Face tokenizer, which falls back to bytes without
it), and the entry points refuse to fall back to the CPU unless asked."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "polyrl_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m == "jax" or m.startswith(("jax.", "jaxlib", "flax", "optax"))
           or m == "polyrl_tpu" or m.startswith("polyrl_tpu.")
           or m.split(".")[0] == "safetensors"
           or (m.split(".")[0] == "transformers"
               and path.name != "tokenizer.py")]
    assert not bad, f"{path.name} imports {bad}"


SLICE_13 = ("rollout/autoscale.py", "rollout/spotmarket.py",
            "rewards/sandbox.py", "tools/health_report.py",
            "tools/kv_report.py", "tools/engine_report.py",
            "tools/fleet_report.py", "tools/trace2perfetto.py")


@pytest.mark.parametrize("rel", SLICE_13)
def test_slice_modules_are_scanned(rel):
    """The closed-loop autoscaling slice's modules and the report tools
    (``polyrl_tpu_torch/tools/``) are in the scan above."""
    assert ROOT / "polyrl_tpu_torch" / rel in PORT_FILES


SLICE_15 = ("parallel/__init__.py", "parallel/mesh.py",
            "parallel/distributed.py", "parallel/multihost.py",
            "parallel/sequence.py", "parallel/fsdp.py")


@pytest.mark.parametrize("rel", SLICE_15)
def test_parallel_modules_are_scanned(rel):
    """The multi-process trainer's modules (``polyrl_tpu_torch/parallel/``)
    are in the scan above and in the jax-blocked import below."""
    assert ROOT / "polyrl_tpu_torch" / rel in PORT_FILES


def test_spawned_world_worker_imports_no_jax():
    """The gloo worlds' worker (``tests/torch_dist.py``) runs the port
    alone: it imports neither JAX nor the JAX package."""
    path = ROOT / "tests" / "torch_dist.py"
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "polyrl_tpu")]
    assert not bad, bad


def test_port_and_chip_smoke_import_with_jax_blocked():
    """In a fresh interpreter where ``import jax`` fails, every module of
    the port and chip_smoke.py import."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "polyrl_tpu_torch").rglob("*.py"))
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['polyrl_tpu'] = None\n"
        "sys.modules['safetensors'] = None\n"
        "sys.modules['transformers'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "import chip_smoke\n"
        "assert 'jax' not in {k for k, v in sys.modules.items() if v}\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from polyrl_tpu_torch.device import resolve_device
    from polyrl_tpu_torch.models import decoder
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine

    cfg = decoder.get_config("tiny", dtype=torch.float32)
    params = decoder.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        CBEngine(cfg, params, max_slots=2, page_size=8, max_seq_len=32,
                 prompt_buckets=(16,), num_pages=8)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_serve_cli_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "-m", "polyrl_tpu_torch.rollout.serve", "--model",
         "tiny", "--port", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and "cuda" in out.stderr


def test_chip_smoke_refuses_without_cuda():
    """The smoke script exits non-zero and prints no result line when
    torch.cuda.is_available() is false."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_train_cli_prints_config_and_refuses_missing_cuda():
    """``--print-config`` resolves dotted overrides without a card; a run
    without one fails instead of training on the CPU."""
    out = subprocess.run(
        [sys.executable, "-m", "polyrl_tpu_torch.train", "--print-config",
         "trainer.total_steps=7"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert "total_steps: 7" in out.stdout or '"total_steps": 7' in out.stdout
    assert "device: cuda" in out.stdout or '"device": "cuda"' in out.stdout
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "-m", "polyrl_tpu_torch.train", "model.preset=tiny"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "cuda" in out.stderr


PPO_CLI = ["trainer.adv_estimator=gae", "trainer.use_remove_padding=true",
           "trainer.pipeline_depth=1", "trainer.rollout_is_correction=true",
           "trainer.test_freq=1", "data.val_path=arithmetic",
           "data.arithmetic_size=8", "model.preset=tiny", "model.dtype=float32",
           "rollout.max_slots=16", "rollout.page_size=8",
           "rollout.num_pages=64", "rollout.max_seq_len=64",
           "rollout.prompt_buckets=16", "trainer.train_batch_size=2",
           "trainer.rollout_n=4", "trainer.ppo_mini_batch_size=8",
           "trainer.micro_batch_size=4", "trainer.min_stream_batch_size=8",
           "trainer.max_prompt_length=16", "trainer.max_response_length=16",
           "reward.num_workers=1"]


def test_train_cli_ppo_slice_runs_and_resumes_on_cpu(tmp_path):
    """The slice's configuration through the CLI on the CPU: PPO with the
    critic (GAE) on packed rows, pipelined with TIS, validated every step
    and checkpointed; a second run with more steps resumes from the
    first's last checkpoint. With ``device=cuda`` and no card it raises."""
    ck = tmp_path / "ck"
    common = ["-m", "polyrl_tpu_torch.train", f"trainer.ckpt_dir={ck}"] + PPO_CLI
    out = subprocess.run([sys.executable, *common, "device=cpu",
                          "trainer.total_steps=2"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "critic/vf_loss" in out.stdout and "val/test_score/mean" in out.stdout
    assert sorted(p.name for p in ck.iterdir()) == ["global_step_2"]
    assert {p.name for p in (ck / "global_step_2").iterdir()} == {
        "actor.pt", "critic.pt", "meta.json"}
    out = subprocess.run([sys.executable, *common, "device=cpu",
                          "trainer.total_steps=3"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "'training/resumed_from_step': 2" in out.stdout
    assert "[step 3]" in out.stdout and "[step 1]" not in out.stdout
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, *common, "trainer.total_steps=1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "cuda" in out.stderr
