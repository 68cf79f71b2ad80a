"""The port's entry scripts: ``examples/torch_*.py`` and ``tools/torch_*.py``.

Each script's ``main`` runs here at a small size with ``--device cpu``
and prints its OK line (the reference script's own line: ``... smoke:
OK``, ``distributed smoke: PASS``, and for the examples the last line the
reference example prints). A child process imports all ten with
``sys.modules["jax"] = None`` and finds no module of the reference
loaded; with no card and no ``--device`` each ``main`` that touches a
tensor raises.

Two scripts are held to the reference script on the same inputs, output
for output:

  * ``torch_reward_analysis`` (numpy data from seed 0, no training) prints
    the tables of ``examples/reward_analysis.py`` at its 2000 queries;
  * ``torch_trace_export`` and ``tools/trace_export.py``, run on the trace
    and the stream that ``torch_obs_smoke`` writes, print the same lines
    and write the same files in each of the four modes.

The other eight train a router or an LM from torch's generator, where the
reference draws from JAX's, so their numbers differ from the reference
script's by design, and only their OK lines and their own checks are
asserted here. What they compute is held to the reference elsewhere, on
weights carried across: the predictors and their training in
``test_torch_training.py``, serving in ``test_torch_serving.py``, the
online, cascade and obs smokes' scenarios in both packages in
``test_torch_online.py``, ``test_torch_cascade.py`` and
``test_torch_obs.py``, the fleet in ``test_torch_fleet.py`` and
``test_torch_socket.py``, LM training in ``test_torch_lm_train.py`` and
``test_torch_launch.py``.

The file holds torch at two threads while it runs and patches no module
(the reference's ``trace_export`` reads ``sys.argv``, which is set for
its call).
"""
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

SCRIPTS = {
    "torch_quickstart": "examples/torch_quickstart.py",
    "torch_reward_analysis": "examples/torch_reward_analysis.py",
    "torch_routed_serving": "examples/torch_routed_serving.py",
    "torch_train_lm": "examples/torch_train_lm.py",
    "torch_serving_smoke": "tools/torch_serving_smoke.py",
    "torch_online_smoke": "tools/torch_online_smoke.py",
    "torch_cascade_smoke": "tools/torch_cascade_smoke.py",
    "torch_obs_smoke": "tools/torch_obs_smoke.py",
    "torch_trace_export": "tools/torch_trace_export.py",
    "torch_distributed_smoke": "tools/torch_distributed_smoke.py",
}

# The line each script prints when it passes (a prefix of it).
OK_LINES = {
    "torch_quickstart": "oracle R2 ",
    "torch_reward_analysis": "  gpt-4 ",
    "torch_routed_serving": "   governor: final lambda ",
    "torch_train_lm": "greedy sample: ",
    "torch_serving_smoke": "serving smoke: OK",
    "torch_online_smoke": "online smoke: OK",
    "torch_cascade_smoke": "cascade smoke: OK",
    "torch_obs_smoke": "obs smoke: OK",
    "torch_trace_export": "valid chrome trace, well-formed span tree",
    "torch_distributed_smoke": "distributed smoke: PASS",
}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file runs, so that parallel test
    workers do not each start one per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def load(name):
    """The script's module, imported from its file under a name of its own."""
    spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                  os.path.join(ROOT, SCRIPTS[name]))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main(capsys, name, argv, **sizes):
    rc = load(name).main(["--device", "cpu", *argv], **sizes)
    out = capsys.readouterr().out
    assert rc == 0, out[-3000:]
    assert any(line.startswith(OK_LINES[name]) for line in out.splitlines()), out[-3000:]
    return out


# Sizes cut for the CPU; each default is the reference script's.
SMALL = {
    "torch_quickstart": ([], {"n_queries": 400, "epochs": 5}),
    "torch_reward_analysis": ([], {"n_queries": 400}),
    "torch_routed_serving": ([], {"epochs": 3, "n_traffic": 200, "n_steady": 16,
                                  "n_bursty": 48}),
    "torch_serving_smoke": ([], {"epochs": 2, "n_traffic": 200}),
    "torch_online_smoke": ([], {}),
    "torch_cascade_smoke": ([], {}),
}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_script_prints_its_ok_line_on_the_cpu(capsys, name):
    argv, sizes = SMALL[name]
    run_main(capsys, name, argv, **sizes)


def test_quickstart_orders_the_routers_as_the_reference(capsys):
    """The oracle bounds both routers from above at every size."""
    out = run_main(capsys, "torch_quickstart", [], n_queries=400, epochs=5)
    aiq = {line[:22].strip(): float(line[22:30]) for line in out.splitlines()
           if line[:22].strip() in ("attention (paper)", "KNN (k=20)", "oracle R2")}
    assert aiq["oracle R2"] > max(aiq["attention (paper)"], aiq["KNN (k=20)"]) > 0


def test_train_lm_lowers_the_loss_and_writes_its_checkpoint(capsys, tmp_path):
    ckpt = tmp_path / "lm.npz"
    out = run_main(capsys, "torch_train_lm", ["--steps", "4", "--batch", "2", "--seq", "16",
                                              "--checkpoint", str(ckpt)], n_layers=2)
    first, last = (float(x) for x in
                   next(line for line in out.splitlines() if line.startswith("loss: "))
                   .split()[1:4:2])
    assert last < first and ckpt.exists()
    sample = next(line for line in out.splitlines() if line.startswith("greedy sample: "))
    assert len(json.loads(sample.split(": ", 1)[1])) == 16


@pytest.fixture(scope="module")
def obs_dir(tmp_path_factory):
    """The artifacts of one ``torch_obs_smoke`` run (its OK line checked)."""
    out_dir = tmp_path_factory.mktemp("obs_smoke")
    rc = load("torch_obs_smoke").main(["--device", "cpu", "--out-dir", str(out_dir)])
    assert rc == 0
    return out_dir


def test_obs_smoke_writes_its_artifacts(obs_dir):
    names = set(os.listdir(obs_dir))
    assert {"trace.json", "metrics.json", "stream_trace.json", "stream",
            "stream_replay"} <= names
    assert os.listdir(obs_dir / "stream") and "manifest.json" in os.listdir(obs_dir / "stream")


def _load_reference(path):
    spec = importlib.util.spec_from_file_location("_reference_" + os.path.basename(path)[:-3],
                                                  os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reward_analysis_prints_the_references_tables(capsys):
    """The AIQ / sensitivity table, the boundedness lines and the mid-lambda
    query distribution, character for character (``oracle_sweep`` on a
    torch device against the reference's on JAX arrays)."""
    assert _load_reference("examples/reward_analysis.py").main() is None
    want = capsys.readouterr().out
    got = run_main(capsys, "torch_reward_analysis", [])
    assert got.splitlines()[0] == "device: cpu"
    assert got.split("\n", 1)[1] == want


@pytest.mark.parametrize("mode", ["summary", "request", "filter", "concat"])
def test_trace_export_reads_the_obs_smokes_trace(capsys, monkeypatch, obs_dir, tmp_path,
                                                 mode):
    """The port's ``trace_export`` and the reference's on the trace (or the
    stream) of one ``torch_obs_smoke`` run: the same stdout, and in the
    filter and concat modes the same file written."""
    trace = str(obs_dir / "trace.json")

    def argv(out):
        return {"summary": [trace],
                "request": [trace, "--request", "1"],
                "filter": [trace, "--cat", "request", "-o", str(out)],
                "concat": ["concat", str(obs_dir / "stream"), "-o", str(out)]}[mode]

    monkeypatch.setattr(sys, "argv", ["trace_export.py", *argv(tmp_path / "want.json")])
    assert _load_reference("tools/trace_export.py").main() == 0
    want = capsys.readouterr().out
    rc = load("torch_trace_export").main(argv(tmp_path / "got.json"))
    got = capsys.readouterr().out
    assert rc == 0, got
    assert got.replace("got.json", "want.json") == want
    lines = got.splitlines()
    if mode in ("summary", "concat"):
        assert lines[0] == OK_LINES["torch_trace_export"]
    if mode == "request":
        assert lines[-1].startswith("request root: status=done")
    if mode in ("filter", "concat"):
        assert (tmp_path / "got.json").read_bytes() == (tmp_path / "want.json").read_bytes()
        doc = json.loads((tmp_path / "got.json").read_text())
        if mode == "filter":
            assert {e["cat"] for e in doc["traceEvents"] if e.get("ph") != "M"} == {"request"}


def test_distributed_smoke_over_both_transports(capsys, tmp_path, monkeypatch):
    """The local plane and the socket plane (a follower process) on the
    same argv: the script's parity, process, rpc and metrics checks."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    out = run_main(capsys, "torch_distributed_smoke",
                   ["--requests", "12", "--out-dir", str(tmp_path)])
    assert "ok: socket run spanned 2 distinct OS processes" in out
    assert (tmp_path / "summary-socket.json").exists()


@pytest.fixture(scope="module")
def imported_modules():
    """{script: the ``repro`` modules loaded after importing it}, from one
    child process in which ``import jax`` fails."""
    code = (
        "import importlib.util, json, sys\n"
        "sys.modules['jax'] = None\n"
        f"scripts = {json.dumps({k: os.path.join(ROOT, v) for k, v in SCRIPTS.items()})}\n"
        "res = {}\n"
        "for name, path in scripts.items():\n"
        "    spec = importlib.util.spec_from_file_location('_s_' + name, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "    res[name] = sorted(m for m in sys.modules if m == 'repro' or m.startswith('repro.'))\n"
        "print(json.dumps(res))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"},
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_imports_no_jax_and_no_reference_module(imported_modules, name):
    assert imported_modules[name] == []


@pytest.mark.parametrize("name", sorted(set(SCRIPTS) - {"torch_trace_export"}))
def test_script_without_a_device_raises_without_a_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the raise without a card needs a machine without one")
    argv = {"torch_obs_smoke": ["--out-dir", str(tmp_path)],
            "torch_distributed_smoke": ["--out-dir", str(tmp_path)],
            "torch_train_lm": ["--checkpoint", str(tmp_path / "lm.npz")]}.get(name, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(name).main(argv)


def test_trace_export_takes_no_device_and_reads_a_trace_anywhere(capsys, obs_dir):
    """The one host-only script: no ``--device`` option, and it runs with
    or without a card."""
    mod = load("torch_trace_export")
    assert mod.main([str(obs_dir / "trace.json")]) == 0
    assert capsys.readouterr().out.startswith(OK_LINES["torch_trace_export"])
    with pytest.raises(SystemExit):
        mod.main([str(obs_dir / "trace.json"), "--device", "cpu"])
