"""The port's LM training entry points against the JAX reference: the corpus,
the train / prefill / decode steps, ``train_loop``, the train CLI, LM
checkpoints across the two packages, and the optimizer on list trees.

Smoke configs on the CPU. ``MarkovCorpus`` batches are equal to the
reference's exactly. Three ``make_train_step`` steps against the
reference's jitted ``make_train_step`` on carried params and the same
batches: each loss within 1e-5 relative; the moments, leaf by leaf,
within 1e-3 of the leaf's largest magnitude; the params within lr
(3e-4) abs everywhere and within 1e-6 abs in all but 1e-4 of their
entries. Adam divides each step by sqrt(v): an entry whose gradient is
at the rounding level of the two frameworks' sums moves by up to lr in
either, so the params cannot be held tighter everywhere (seen: 1.6e-4
abs at worst, 3e-5 of the entries above 1e-6; the moments 1.7e-4).
"""
import dataclasses
import json
import subprocess
import sys
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import get_smoke_config as jax_get_smoke
from repro.data.lm_data import MarkovCorpus as JaxMarkovCorpus
from repro.launch import steps as jax_steps
from repro.models import lm as jax_lm
from repro.training.optim import adam_init as jax_adam_init
from repro_torch import bridge
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.common import DEFAULT_POLICY, DTypePolicy
from repro_torch.common.dtypes import BF16_POLICY
from repro_torch.common.tree import flatten_with_paths, tree_map, unflatten_from_paths
from repro_torch.configs import get_smoke_config
from repro_torch.data.lm_data import MarkovCorpus
from repro_torch.launch import steps, train
from repro_torch.models import lm
from repro_torch.training.optim import AdamConfig, adam_init, adam_update, value_and_grad

QWEN, MOE_NAME, VISION = "qwen3-0.6b", "granite-moe-1b-a400m", "llama-3.2-vision-90b"
LOSS_RTOL = 1e-5
MOMENT_TOL = 1e-3
PARAM_ENTRY_TOL, PARAM_OUTLIER_SHARE = 1e-6, 1e-4
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file runs, so that parallel test
    workers do not each start one per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _carried(name):
    jcfg, cfg = jax_get_smoke(name), get_smoke_config(name)
    jp = jax_lm.init_lm(jax.random.key(0), jcfg)
    return jcfg, cfg, jp, bridge.lm_params_from_jax(cfg, jax.tree.map(np.asarray, jp), "cpu")


def _port_layout(cfg, tree):
    return flatten_with_paths(bridge.lm_params_from_jax(cfg, jax.tree.map(np.asarray, tree),
                                                        "cpu"))


# ---------------------------------------------------------------------------
# Corpus
# ---------------------------------------------------------------------------

def test_markov_corpus_batches_equal_the_references():
    ours, ref = MarkovCorpus(300, seed=3), JaxMarkovCorpus(300, seed=3)
    a, b = ours.batches(3, 40, seed=4), ref.batches(3, 40, seed=4)
    for _ in range(3):
        for x, y in zip(next(a), next(b)):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    a, b = ours.padded_batches(4, 40, seed=5), ref.padded_batches(4, 40, seed=5)
    for _ in range(3):
        for x, y in zip(next(a), next(b)):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    with pytest.raises(ValueError, match="min_len"):
        next(ours.padded_batches(2, 8, min_len=9))


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def _assert_state_close(cfg, params, state, jparams, jstate):
    for got, want, kind in ((state.m, jstate.m, "m"), (state.v, jstate.v, "v")):
        g, w = flatten_with_paths(got), _port_layout(cfg, want)
        for key in w:
            err, scale = float((g[key] - w[key]).abs().max()), float(w[key].abs().max())
            assert err <= MOMENT_TOL * scale, (kind, key, err, scale)
    g, w = flatten_with_paths(params), _port_layout(cfg, jparams)
    diff = torch.cat([(g[k] - w[k]).abs().flatten() for k in w])
    assert float(diff.max()) <= steps.TRAIN_ADAM.lr
    assert float((diff > PARAM_ENTRY_TOL).float().mean()) <= PARAM_OUTLIER_SHARE
    assert int(state.step) == int(jstate.step)


@pytest.mark.parametrize("name,microbatch", [(QWEN, 1), (QWEN, 2), (MOE_NAME, 1)],
                         ids=["qwen3", "qwen3-microbatch-2", "granite-moe"])
def test_train_steps_match_the_references_jitted_step(name, microbatch):
    jcfg, cfg, jp, tp = _carried(name)
    jstate, state = jax_adam_init(jax_steps.TRAIN_ADAM, jp), adam_init(steps.TRAIN_ADAM, tp)
    jstep = jax.jit(jax_steps.make_train_step(jcfg, None, jax_steps.TRAIN_ADAM,
                                              microbatch=microbatch))
    step = steps.make_train_step(cfg, None, steps.TRAIN_ADAM, microbatch=microbatch)
    batches = MarkovCorpus(cfg.vocab_size, seed=0).batches(4, 32, seed=1)
    for _ in range(3):
        tok, lab = next(batches)
        jloss, jp, jstate = jstep(jp, jstate, {"tokens": jnp.asarray(tok),
                                               "labels": jnp.asarray(lab)})
        loss, tp, state = step(tp, state, {"tokens": torch.from_numpy(tok),
                                           "labels": torch.from_numpy(lab)})
        assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert isinstance(tp["layers"], list) and len(tp["layers"]) == len(cfg.layer_plan())
    _assert_state_close(cfg, tp, state, jp, jstate)


def test_masked_train_step_matches_the_references_jitted_step():
    jcfg, cfg, jp, tp = _carried(MOE_NAME)
    jstate, state = jax_adam_init(jax_steps.TRAIN_ADAM, jp), adam_init(steps.TRAIN_ADAM, tp)
    tok, lab, mask = next(MarkovCorpus(cfg.vocab_size, seed=0).padded_batches(4, 32, seed=1))
    jloss, jp, jstate = jax.jit(jax_steps.make_train_step(jcfg))(
        jp, jstate, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab),
                     "attn_mask": jnp.asarray(mask)})
    loss, tp, state = steps.make_train_step(cfg)(
        tp, state, {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab),
                    "attn_mask": torch.from_numpy(mask)})
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    _assert_state_close(cfg, tp, state, jp, jstate)


def test_train_step_updates_in_place_with_the_functional_numbers():
    """The step takes its params and moments over (the reference donates
    both): it returns the trees it was given, each leaf updated in its own
    tensor, bit for bit what ``value_and_grad`` + a functional
    ``adam_update`` give."""
    cfg = get_smoke_config(QWEN)
    batch = {k: torch.from_numpy(v) for k, v in zip(
        ("tokens", "labels"), next(MarkovCorpus(cfg.vocab_size).batches(2, 16, seed=1)))}
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    state = adam_init(steps.TRAIN_ADAM, params)
    loss, grads = value_and_grad(
        lambda p: lm.lm_loss(cfg, p, batch["tokens"], batch["labels"]), params)
    new, new_state = adam_update(steps.TRAIN_ADAM, grads, state, params)
    leaf = params["layers"][1]["mixer"]["wq"]
    dloss, dparams, dstate = steps.make_train_step(cfg)(params, state, batch)
    assert dparams is params and dparams["layers"][1]["mixer"]["wq"] is leaf
    assert dstate.m is state.m and float(dloss) == float(loss)
    for got, want in ((dparams, new), (dstate.m, new_state.m), (dstate.v, new_state.v)):
        g, w = flatten_with_paths(got), flatten_with_paths(want)
        assert all(torch.equal(g[k], w[k]) for k in w)


def test_train_step_on_a_zeros_batch_and_the_mesh_refusal():
    """The intent of the reference's own failing
    ``test_launch.py::TestSmallMeshEndToEnd::test_train_step_jits_on_1x1_mesh``:
    a zeros (4, 32) batch on smoke qwen3 gives a finite loss, unsharded and
    on a 1x1 gloo mesh (its process group destroyed after). What the port
    still refuses: a mesh that is not a ``DeviceMesh`` or lacks the
    ``data``/``model`` dims, in the steps, ``train_loop`` and
    ``distributed/shard.py::shard_pool`` alike."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.shard import shard_pool
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import sharding

    cfg = get_smoke_config(QWEN)
    zeros = torch.zeros((4, 32), dtype=torch.int32)
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    loss, params, opt = steps.make_train_step(cfg)(params, adam_init(steps.TRAIN_ADAM, params),
                                                   {"tokens": zeros, "labels": zeros})
    assert np.isfinite(float(loss))
    mesh = mesh_mod.make_debug_mesh(1, 1, device="cpu")
    try:
        params = sharding.distribute_params(
            cfg, mesh, lm.init_lm(torch.Generator().manual_seed(0), cfg))
        batch = sharding.distribute_batch(mesh, {"tokens": zeros, "labels": zeros})
        mesh_loss, _, _ = steps.make_train_step(cfg, mesh)(
            params, adam_init(steps.TRAIN_ADAM, params), batch)
        assert np.isfinite(float(mesh_loss))
        flat = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        for make in (steps.make_train_step, steps.make_prefill_step, steps.make_decode_step):
            with pytest.raises(TypeError, match="DeviceMesh"):
                make(cfg, mesh=object())
            with pytest.raises(ValueError, match="mesh dims"):
                make(cfg, mesh=flat)
        with pytest.raises(TypeError, match="DeviceMesh"):
            train.train_loop(cfg, steps=1, batch=2, seq=8, mesh=object(), device="cpu")
        with pytest.raises(TypeError, match="DeviceMesh"):
            shard_pool([], 0, 1, mesh=object())
    finally:
        dist.destroy_process_group()


def test_prefill_and_decode_steps_match_the_reference():
    jcfg, cfg, jp, tp = _carried(QWEN)
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jlogits, jcaches = jax_steps.make_prefill_step(jcfg)(
        jp, {"tokens": jnp.asarray(tok), "caches": jax_lm.init_caches(jcfg, 2, 16)})
    logits, caches = steps.make_prefill_step(cfg)(
        tp, {"tokens": torch.from_numpy(tok), "caches": lm.init_caches(cfg, 2, 16, "cpu")})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=2e-5)
    nxt = np.argmax(np.asarray(jlogits)[:, -1, :cfg.vocab_size], -1)[:, None].astype(np.int32)
    jlogits, _ = jax_steps.make_decode_step(jcfg)(
        jp, {"token": jnp.asarray(nxt), "caches": jcaches, "pos": jnp.int32(12)})
    logits, _ = steps.make_decode_step(cfg)(
        tp, {"token": torch.from_numpy(nxt), "caches": caches, "pos": 12})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=2e-5)


# ---------------------------------------------------------------------------
# train_loop and the CLI
# ---------------------------------------------------------------------------

def test_train_loop_learns_and_replays_under_its_seed(capsys):
    cfg = get_smoke_config(QWEN)
    kw = dict(steps=30, batch=8, seq=32, lr=3e-3, seed=0, log_every=10, device="cpu")
    params, losses = train.train_loop(cfg, **kw)
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) - 0.3
    again, losses2 = train.train_loop(cfg, **kw)
    assert losses2 == losses
    a, b = flatten_with_paths(params), flatten_with_paths(again)
    assert all(torch.equal(a[k], b[k]) for k in a)
    out = capsys.readouterr().out
    assert out.count("step ") == 2 * 4 and "loss" in out


def test_train_loop_var_len_runs_masked_batches():
    cfg = get_smoke_config(MOE_NAME)
    _, losses = train.train_loop(cfg, steps=3, batch=4, seq=32, var_len=True, log_every=1,
                                 device="cpu")
    assert len(losses) == 3 and np.isfinite(losses).all()


def test_checkpoint_crosses_both_ways(tmp_path):
    """The port's checkpoint loads in the reference against a reference
    template; a reference checkpoint loads in the port through the bridge."""
    jcfg, cfg = jax_get_smoke(VISION), get_smoke_config(VISION)
    path = str(tmp_path / "port.npz")
    media = torch.zeros((2, cfg.n_frontend_tokens, cfg.frontend_dim))
    params, _ = train.train_loop(cfg, steps=2, batch=2, seq=16, checkpoint_path=path,
                                 media_fn=lambda i: media, device="cpu")
    template = jax_lm.init_lm(jax.random.key(1), jcfg)
    loaded, meta = jax_load_checkpoint(path, template)
    assert meta == {"arch": cfg.name, "steps": 2}
    got, want = _port_layout(cfg, loaded), flatten_with_paths(params)
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)

    ref_path = str(tmp_path / "ref.npz")
    jax_save_checkpoint(ref_path, template, {"arch": "ref"})
    port_template = bridge.lm_params_to_jax(cfg, lm.init_lm(torch.Generator(), cfg))
    tree, meta = load_checkpoint(ref_path, port_template)
    assert meta == {"arch": "ref"} and isinstance(tree["pattern"], tuple)
    ported = flatten_with_paths(bridge.lm_params_from_jax(cfg, tree, "cpu"))
    want = _port_layout(cfg, template)
    assert ported.keys() == want.keys()
    assert all(torch.equal(ported[k], want[k]) for k in want)


def test_lm_params_to_jax_inverts_the_bridge():
    jcfg, cfg, jp, tp = _carried("jamba-1.5-large-398b")
    back = flatten_with_paths(bridge.lm_params_to_jax(cfg, tp))
    want = flatten_with_paths(jax.tree.map(np.asarray, jp))
    assert back.keys() == want.keys()
    assert all(back[k].shape == want[k].shape and np.array_equal(back[k], want[k])
               for k in want)
    with pytest.raises(ValueError, match="layers of params"):
        bridge.lm_params_to_jax(cfg, {**tp, "layers": tp["layers"][:-1]})


def test_load_checkpoint_refuses_missing_keys_and_other_shapes(tmp_path):
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, {"a": torch.ones(2, 3), "b": [torch.zeros(4)]}, {"k": 1})
    tree, meta = load_checkpoint(path, {"a": torch.zeros(2, 3, dtype=torch.float64),
                                        "b": [np.zeros(4, np.float32)]})
    assert meta == {"k": 1} and tree["a"].dtype == torch.float64
    assert torch.equal(tree["a"], torch.ones(2, 3, dtype=torch.float64))
    assert isinstance(tree["b"], list) and isinstance(tree["b"][0], np.ndarray)
    with pytest.raises(KeyError, match="missing parameter 'c'"):
        load_checkpoint(path, {"a": torch.zeros(2, 3), "c": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape mismatch for 'a'"):
        load_checkpoint(path, {"a": torch.zeros(3, 2), "b": [torch.zeros(4)]})


def test_main_trains_the_smoke_config_on_the_cpu(tmp_path, capsys):
    path = str(tmp_path / "cli.npz")
    assert train.main(["--arch", QWEN, "--smoke", "--steps", "3", "--batch", "2",
                       "--seq", "16", "--checkpoint", path, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "first loss" in out and f"saved checkpoint to {path}" in out
    assert os.path.exists(path)


def test_main_gives_a_vlm_config_seeded_media(capsys):
    assert train.main(["--arch", VISION, "--smoke", "--steps", "2", "--batch", "2",
                       "--seq", "16", "--var-len", "--device", "cpu"]) == 0
    assert "first loss" in capsys.readouterr().out


def test_module_runs_as_a_script(tmp_path):
    """``python -m repro_torch.launch.train`` as the README gives it."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", QWEN, "--smoke",
         "--steps", "2", "--batch", "2", "--seq", "16", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
        env={**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith("first loss")


# ---------------------------------------------------------------------------
# Optimizer trees and the dtype policy
# ---------------------------------------------------------------------------

def _layer_tree():
    """Twelve layers: ``"10"`` sorts before ``"2"`` as a string."""
    return {"layers": [{"w": torch.full((2,), float(i + 1)), "b": torch.tensor(float(i))}
                       for i in range(12)],
            "pair": (torch.ones(3), torch.zeros(1)), "scale": torch.ones(())}


def test_optimizer_keeps_list_structure_and_order():
    params = _layer_tree()

    def loss_fn(p):
        return sum((i + 1) * (layer["w"].sum() + layer["b"])
                   for i, layer in enumerate(p["layers"])) + (p["pair"][0].sum() * p["scale"]
                                                            + p["pair"][1].sum())

    loss, grads = value_and_grad(loss_fn, params)
    assert isinstance(grads["layers"], list) and len(grads["layers"]) == 12
    assert isinstance(grads["pair"], tuple)
    for i, g in enumerate(grads["layers"]):
        assert torch.equal(g["w"], torch.full((2,), float(i + 1)))
        assert float(g["b"]) == i + 1
    cfg = AdamConfig(lr=0.1)
    for donate in (False, True):
        p = tree_map(torch.clone, params)
        new, state = adam_update(cfg, grads, adam_init(cfg, p), p, donate=donate)
        assert isinstance(new["layers"], list) and isinstance(new["pair"], tuple)
        assert isinstance(state.m["layers"], list) and isinstance(state.v["pair"], tuple)
        for i, layer in enumerate(new["layers"]):
            # The first Adam step moves each entry by lr against its gradient's sign.
            assert torch.allclose(layer["w"], torch.full((2,), i + 1 - 0.1))
            assert torch.allclose(state.m["layers"][i]["b"], torch.tensor(0.1 * (i + 1)))


def test_unflatten_from_paths_rebuilds_the_template():
    template = _layer_tree()
    flat = flatten_with_paths(template)
    rebuilt = unflatten_from_paths(template, dict(reversed(list(flat.items()))))
    assert isinstance(rebuilt["layers"], list) and isinstance(rebuilt["pair"], tuple)
    assert [float(layer["b"]) for layer in rebuilt["layers"]] == list(range(12))
    assert list(rebuilt) == sorted(template)
    with pytest.raises(KeyError, match="missing parameter 'layers/11/w'"):
        unflatten_from_paths(template, {k: v for k, v in flat.items() if k != "layers/11/w"})
    with pytest.raises(ValueError, match="shape mismatch for 'scale'"):
        unflatten_from_paths(template, {**flat, "scale": torch.ones(2)})


def test_unflatten_from_paths_keeps_no_reference_to_the_flat_dict():
    """The rebuild leaves no reference cycle that holds the flat dict (a
    train step's gradients) until the garbage collector runs: with the
    collector off, the dict is freed as soon as the caller drops it."""
    import gc
    import weakref

    class Flat(dict):
        pass

    flat = Flat(flatten_with_paths(_layer_tree()))
    ref = weakref.ref(flat)
    enabled = gc.isenabled()
    gc.disable()
    try:
        rebuilt = unflatten_from_paths(_layer_tree(), flat)
        del flat
        assert ref() is None
    finally:
        if enabled:
            gc.enable()
    assert len(rebuilt["layers"]) == 12


def test_dtype_policy():
    assert DEFAULT_POLICY == DTypePolicy()
    x = torch.ones(2, dtype=torch.float64)
    assert DEFAULT_POLICY.cast_param(x).dtype == torch.float32
    assert BF16_POLICY.cast_compute(x).dtype == torch.bfloat16
    assert BF16_POLICY.accum_dtype == torch.float32
    assert dataclasses.replace(BF16_POLICY, param_dtype=torch.float16).param_dtype == torch.float16


def test_the_cli_flags_are_the_references_plus_device():
    args = train.parse_args(["--arch", QWEN])
    assert json.loads(json.dumps(vars(args))) == {
        "arch": QWEN, "smoke": False, "steps": 100, "batch": 8, "seq": 128, "lr": 3e-4,
        "checkpoint": None, "var_len": False, "device": None}
