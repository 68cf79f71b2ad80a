"""Each cell's path end to end on the CPU at smoke size, through the
runners the command calls (the command itself refuses without a card)."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from portbench import serving, training
from portbench.common import ROOT
from portbench.tests.smoke import smoke_cell

SEED = 3_000_000_019   # past 31 bits, as the driver's seeds are


@pytest.mark.parametrize("cell", ["pool3.steady", "pool3.backlog"])
def test_serving_cell_runs_and_is_correct(cell):
    out = serving.run(smoke_cell(cell), SEED, 1.5, False, device="cpu", smoke=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {"e2e_p95_ms", "e2e_p50_ms"} if cell.endswith("steady") else {"tokens_per_s"}
    assert set(out["metrics"]) == want | {"setup_s"}
    assert all(v > 0 for v in out["metrics"].values())


def test_training_cell_runs_and_is_correct():
    out = training.run(smoke_cell("granite-moe-1b-a400m.train"), SEED, 1.0, False,
                       device="cpu", smoke=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_tokens_per_s", "setup_s"}
    # The first steps agree with the reference to float32 rounding here.
    assert all(c["value"] < 1e-4 for c in out["checks"].values())


def test_same_seed_same_inputs():
    from portbench import generator
    mix = smoke_cell("pool3.steady")["traffic"]
    a = generator.requests(mix, 20, SEED, 100)
    b = generator.requests(mix, 20, SEED, 100)
    c = generator.requests(mix, 20, SEED + 1, 100)
    assert all((x["prompt"] == y["prompt"]).all() and x["text"] == y["text"] for x, y in zip(a, b))
    # Another seed: the same shapes in another order.
    key = lambda r: (r["text"], r["prompt_len"], r["max_new"])  # noqa: E731
    assert sorted(map(key, a)) == sorted(map(key, c)) and list(map(key, a)) != list(map(key, c))
    gaps = [np.sort(np.diff(generator.open_loop_due(mix, 3.0, s), prepend=0.0)) for s in (1, 2)]
    assert gaps[0] == pytest.approx(gaps[1]) and len(gaps[0]) == round(3.0 * mix["rate_per_s"])


def test_every_backlog_round_and_training_step_gets_the_same_work():
    from portbench import generator
    cell = smoke_cell("pool3.backlog")
    mix, size = cell["traffic"], cell["scheduler"]["score_batch"]
    key = lambda r: (r["text"], r["prompt_len"], r["max_new"])  # noqa: E731
    runs = []
    for seed in (SEED, SEED + 1):
        reqs = generator.requests(mix, 3 * size, seed, 100, round_size=size)
        runs.append([list(map(key, reqs[i:i + size])) for i in range(0, 3 * size, size)])
    # Each round: the same work for every seed, in the seed's order.
    assert [sorted(r) for r in runs[0]] == [sorted(r) for r in runs[1]]
    assert runs[0] != runs[1]
    # Rounds are not copies of one another.
    assert sorted(runs[0][0]) != sorted(runs[0][1])
    mix = smoke_cell("granite-moe-1b-a400m.train")["traffic"]
    _, _, mask = generator.lm_rows(mix, 4 * mix["batch"], 64, SEED)
    per_step = mask.reshape(4, mix["batch"], -1).sum(axis=(1, 2))
    assert (per_step == per_step[0]).all()


def _command(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "pool3.steady",
                           "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_command_refuses_without_a_card():
    proc = _command(ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_command_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    proc = _command(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    with pytest.raises(json.JSONDecodeError):
        json.loads(proc.stdout or "x")
