"""The port's report tools (``polyrl_tpu_torch/tools/``) against the
repository's ``tools/`` on the same inputs, made by the port: a flight
recorder bundle and the step records of a traced, pipelined fit on the
port's trainer (``health_report``, ``fleet_report``), a ``/statusz``
snapshot of the port's engine (``engine_report``, ``kv_report``) and the
span dumps of two processes (``trace2perfetto``). Each tool must exit with
the reference's code and render the same text (``trace2perfetto``: the
same merged trace). Also ``tools/check_metric_names.py`` over the port's
package must be clean.
"""

import importlib.util
import json
import pathlib
import subprocess
import sys
import urllib.request

import pytest

from polyrl_tpu_torch import obs
from polyrl_tpu_torch.obs.recorder import FlightRecorder
from polyrl_tpu_torch.rollout.serve import create_server
from polyrl_tpu_torch.tools import (engine_report, fleet_report,
                                    health_report, kv_report, trace2perfetto)
from test_torch_pipeline import FakeRollout, make_trainer

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = {"health_report": health_report, "fleet_report": fleet_report,
        "engine_report": engine_report, "kv_report": kv_report,
        "trace2perfetto": trace2perfetto}


def _reference(name: str):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SPAN_SCRIPT = """
import sys, time
from polyrl_tpu_torch import obs
obs.configure(trace=True, out_dir=sys.argv[1], reset=True)
for i in range(3):
    with obs.span("engine/generate", rid=f"r{i}"):
        time.sleep(0.002)
obs.get_tracer().export_run()
"""


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A traced 3-step pipelined fit with a flight recorder (a manual
    bundle, its step records, its spans), a second process's spans, and a
    served engine's ``/statusz``."""
    tmp = tmp_path_factory.mktemp("reports")
    obs.configure(trace=True, out_dir=str(tmp / "trainer"), max_spans=8192,
                  reset=True)
    try:
        rec = FlightRecorder(str(tmp / "run"), warmup=3)
        trainer = make_trainer(FakeRollout(gen_delay_s=0.01), total_steps=3,
                               depth=1, rollout_is_correction=True)
        trainer._recorder = rec
        rec.training_fn = trainer._health.bundle_view
        rec.critical_path_fn = trainer._critical_path_view
        history = trainer.fit()  # each record reaches the recorder
        bundle = rec.dump("probe", detail="report tools", step=3)
        assert bundle is not None
    finally:
        obs.configure(trace=False, reset=True)
    steps = tmp / "steps.jsonl"
    steps.write_text("".join(json.dumps(r) + "\n" for r in history))
    subprocess.run([sys.executable, "-c", _SPAN_SCRIPT, str(tmp / "server")],
                   cwd=ROOT, check=True, timeout=120)

    srv = create_server("tiny", device="cpu", host="127.0.0.1", port=0,
                        dtype="float32", max_slots=4, page_size=8,
                        max_seq_len=96, num_pages=64, prompt_buckets=(16,))
    try:
        srv.engine.generate([[5, 3, 9, 2, 7]] * 2, _greedy(6))
        with urllib.request.urlopen(
                f"http://{srv.endpoint}/statusz", timeout=30) as r:
            snap = json.load(r)
        live = srv.endpoint
        live_out = {n: _run(PORT[n], [live]) for n in ("engine_report",
                                                       "kv_report")}
    finally:
        srv.stop()
    statusz = tmp / "statusz.json"
    statusz.write_text(json.dumps(snap))
    return dict(bundle=str(bundle), steps=str(steps), statusz=str(statusz),
                spans=[str(tmp / "trainer"), str(tmp / "server")],
                tmp=tmp, live=live_out, history=history)


def _greedy(n):
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    return SamplingParams(temperature=0.0, max_new_tokens=n)


def _run(mod, argv):
    """``mod.main(argv)``'s exit code and standard output."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, buf.getvalue()


CASES = [
    ("health_report", "bundle", []),
    ("health_report", "steps", ["--last", "2", "--z", "2.0", "--warmup", "2"]),
    ("fleet_report", "bundle", []),
    ("fleet_report", "steps", ["--last", "3", "--width", "24"]),
    ("engine_report", "statusz", []),
    ("kv_report", "statusz", []),
]


@pytest.mark.parametrize("name,source,extra", CASES,
                         ids=[f"{n}-{s}{'-args' if e else ''}"
                              for n, s, e in CASES])
def test_report_renders_as_the_reference(inputs, name, source, extra):
    argv = [inputs[source]] + extra
    ours = _run(PORT[name], argv)
    ref = _run(_reference(name), argv)
    assert ours == ref
    rc, text = ours
    assert rc == 0 and text.strip()


def test_reports_refuse_missing_input_as_the_reference(inputs):
    missing = str(inputs["tmp"] / "nothing.jsonl")
    for name in ("health_report", "fleet_report"):
        ours = _run(PORT[name], [missing])
        assert ours == _run(_reference(name), [missing])
        assert ours[0] == 2


def test_trace_merge_equals_the_reference(inputs):
    out_a = inputs["tmp"] / "merged_port.json"
    out_b = inputs["tmp"] / "merged_ref.json"
    rc_a, text_a = _run(trace2perfetto, inputs["spans"] + ["-o", str(out_a)])
    rc_b, text_b = _run(_reference("trace2perfetto"),
                        inputs["spans"] + ["-o", str(out_b)])
    assert rc_a == rc_b == 0
    assert text_a.replace(str(out_a), "OUT") == text_b.replace(str(out_b),
                                                               "OUT")
    merged = json.loads(out_a.read_text())
    assert merged == json.loads(out_b.read_text())
    # two processes, each led by its clock anchor
    pids = {e.get("pid") for e in merged["traceEvents"] if e.get("ph") == "X"}
    assert len(pids) == 2
    assert "2 clock anchors" in text_a


def test_live_statusz_renders(inputs):
    for name, (rc, text) in inputs["live"].items():
        assert rc == 0 and "statusz" in text, name


@pytest.mark.parametrize("name", sorted(PORT))
def test_tool_runs_as_a_module(inputs, name):
    """``python -m polyrl_tpu_torch.tools.<name>`` with the JAX package
    made unimportable."""
    arg = {"health_report": inputs["bundle"], "fleet_report": inputs["steps"],
           "engine_report": inputs["statusz"], "kv_report": inputs["statusz"],
           "trace2perfetto": inputs["spans"][0]}[name]
    extra = (["-o", str(inputs["tmp"] / "cli_trace.json")]
             if name == "trace2perfetto" else [])
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['polyrl_tpu'] = None\n"
            f"sys.argv = ['{name}', {arg!r}] + {extra!r}\n"
            f"runpy.run_module('polyrl_tpu_torch.tools.{name}', "
            "run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip()


def test_metric_names_of_the_port_are_clean():
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "check_metric_names.py"),
         str(ROOT / "polyrl_tpu_torch")],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "metric names ok"
