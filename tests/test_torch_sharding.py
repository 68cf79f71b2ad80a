"""The port's sharding rules, shapes, configs and collective accounting
against the JAX reference's own functions.

Mirrors ``tests/test_launch.py`` class by class. The rule tables run on
an ``AbstractMesh`` of the production shape on both sides (16x16 and
2x16x16; no devices): every parameter leaf's spec of all ten configs,
every cache leaf's spec at decode_32k and long_500k, and the batch specs
equal the reference's, as tuples. The port's params are per layer
(``layers/<i>/...``), so a layer's spec is compared with the reference's
for its ``pattern/<j>`` leaf without the leading repeat axis, or with its
``remainder/<j>`` leaf. ``collective_bytes_per_device`` takes the
reference's own inventory. The dry-run runs once as a child process on
the fake 16x16 mesh at smoke size.
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.common.tree import flatten_with_paths as jax_flatten
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke
from repro.configs import shapes as jax_shapes
from repro.launch import sharding as jsh
from repro.launch.hlo_analysis import collective_bytes_per_device as jax_collective_bytes
from repro.models import lm as jax_lm
from repro_torch.common.tree import flatten_with_paths
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.shapes import SHAPE_IDS, SHAPES, input_specs, shape_applicable
from repro_torch.launch import sharding
from repro_torch.launch.hlo_analysis import StepCounter, collective_bytes_per_device, summarize
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import lm
from repro_torch.models import sharding_ctx as ctx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1"}
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _meshes(name):
    sizes, names = MESHES[name]
    try:
        jmesh = JaxAbstractMesh(sizes, names)
    except TypeError:       # older jax: AbstractMesh of (name, size) pairs
        jmesh = JaxAbstractMesh(tuple(zip(names, sizes)))
    return jmesh, AbstractMesh(sizes, names)


def _ref_layer(cfg, i):
    """(``pattern`` or ``remainder``, position) of the port's layer ``i``."""
    n = len(cfg.pattern)
    if i < cfg.n_repeats * n:
        return "pattern", i % n
    return "remainder", i - cfg.n_repeats * n


def _ref_path(cfg, path):
    """The reference's leaf path for a port path, and whether it is stacked."""
    parts = path.split("/")
    if parts[0] != "layers":
        return path, False
    group, pos = _ref_layer(cfg, int(parts[1]))
    return "/".join([group, str(pos), *parts[2:]]), group == "pattern"


def _divides(shape, spec, mesh):
    for dim, ax in zip(shape, spec):
        if ax is not None:
            size = np.prod([mesh.shape[mesh.mesh_dim_names.index(a)]
                            for a in (ax if isinstance(ax, tuple) else (ax,))])
            assert dim % size == 0, (shape, spec)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

class TestParamSpecs:
    @pytest.mark.parametrize("mesh_name", list(MESHES))
    @pytest.mark.parametrize("name", ARCH_IDS)
    def test_every_param_spec_equals_the_references(self, name, mesh_name):
        """Leaf for leaf, the port's tree covers the reference's, each spec
        equal (without the repeat axis) and dividing its dim, as jit's
        argument shardings must."""
        jmesh, mesh = _meshes(mesh_name)
        jcfg, cfg = jax_get_config(name), get_config(name)
        ref = jax_flatten(jax_lm.abstract_params(jcfg, dtype=jnp.bfloat16))
        port = flatten_with_paths(lm.abstract_params(cfg))
        shardings = flatten_with_paths(sharding.param_shardings(cfg, mesh, lm.abstract_params(cfg)))
        seen = set()
        for path, leaf in port.items():
            rpath, stacked = _ref_path(cfg, path)
            rleaf = ref[rpath]
            seen.add(rpath)
            assert tuple(leaf.shape) == tuple(rleaf.shape[1:] if stacked else rleaf.shape), path
            want = tuple(jsh.param_spec(jcfg, jmesh, rpath, len(rleaf.shape)))
            got = sharding.param_spec(cfg, mesh, path, leaf.ndim)
            assert got == (want[1:] if stacked else want), (path, got, want)
            assert shardings[path].spec == got
            _divides(leaf.shape, got, mesh)
        assert seen == set(ref)

    def test_the_references_named_cases(self):
        """``test_launch.py::TestParamSpecs``' cases on the port's paths."""
        _, mesh = _meshes("16x16")
        gemma, granite = get_config("gemma3-27b"), get_config("granite-3-8b")
        llama4 = get_config("llama4-maverick-400b-a17b")
        assert sharding.param_spec(gemma, mesh, "embedding/table", 2) == ("model", "data")
        assert sharding.param_spec(gemma, mesh, "embedding/head", 2) == ("data", "model")
        assert sharding.param_spec(granite, mesh, "layers/3/mixer/wq", 2) == ("data", "model")
        assert sharding.param_spec(granite, mesh, "layers/3/mixer/wo", 2) == ("model", "data")
        assert sharding.param_spec(granite, mesh, "layers/3/norm1/scale", 1) == (None,)
        # layer 1 is llama4's first MoE layer
        assert sharding.param_spec(llama4, mesh, "layers/1/ffn/w_gate", 3) == (
            "model", "data", None)
        assert sharding.param_spec(llama4, mesh, "layers/1/ffn/w_down", 3) == (
            "model", None, "data")
        assert sharding.param_spec(llama4, mesh, "layers/1/ffn/shared/w_gate", 2) == (
            "data", "model")
        _, pods = _meshes("2x16x16")
        assert sharding.param_spec(granite, pods, "layers/0/mixer/wq", 2) == (
            ("pod", "data"), "model")


# ---------------------------------------------------------------------------
# Cache and batch specs
# ---------------------------------------------------------------------------

CACHE_CASES = [(name, shape) for name in ARCH_IDS for shape in ("decode_32k", "long_500k")
               if shape_applicable(get_config(name), SHAPES[shape])]


class TestCacheSpecs:
    @pytest.mark.parametrize("mesh_name", list(MESHES))
    @pytest.mark.parametrize("name,shape_name", CACHE_CASES)
    def test_every_cache_spec_equals_the_references(self, name, shape_name, mesh_name):
        jmesh, mesh = _meshes(mesh_name)
        jcfg, cfg = jax_get_config(name), get_config(name)
        shape = SHAPES[shape_name]
        jcaches = jax_lm.abstract_caches(jcfg, shape.global_batch, shape.seq_len)
        jshard = jsh.cache_shardings(jcfg, jmesh, jcaches)
        caches = lm.abstract_caches(cfg, shape.global_batch, shape.seq_len)
        shard = sharding.cache_shardings(cfg, mesh, caches)
        for i, layer in enumerate(caches):
            group, pos = _ref_layer(cfg, i)
            for key, leaf in layer.items():
                rleaf, want = jcaches[group][pos][key], tuple(jshard[group][pos][key].spec)
                stacked = group == "pattern"
                assert tuple(leaf.shape) == tuple(rleaf.shape[1:] if stacked else rleaf.shape)
                got = shard[i][key].spec
                assert got == (want[1:] if stacked else want), (i, key, got, want)
                _divides(leaf.shape, got, mesh)

    def test_long_context_shards_seq_over_all_axes(self):
        """gemma3's global layers (pattern position 5) hold the full 500k
        cache, sharded over every mesh axis for a batch of one."""
        _, mesh = _meshes("16x16")
        cfg = get_config("gemma3-27b")
        caches = lm.abstract_caches(cfg, 1, SHAPES["long_500k"].seq_len)
        specs = sharding.cache_shardings(cfg, mesh, caches)
        assert specs[5]["k"].spec == (None, ("data", "model"), None, None)
        assert caches[0]["k"].shape[1] == 1024                # a local layer's ring


class TestBatchSpecs:
    @pytest.mark.parametrize("mesh_name", list(MESHES))
    @pytest.mark.parametrize("shape_name", SHAPE_IDS)
    @pytest.mark.parametrize("name", ["qwen3-0.6b", "llama-3.2-vision-90b"])
    def test_batch_specs_equal_the_references(self, name, shape_name, mesh_name):
        jmesh, mesh = _meshes(mesh_name)
        shape = SHAPES[shape_name]
        jspecs = jax_shapes.input_specs(jax_get_config(name), jax_shapes.SHAPES[shape_name])
        specs = input_specs(get_config(name), shape)
        for key in ("tokens", "labels", "token", "media"):
            if key in jspecs:
                want = tuple(jsh.batch_shardings(jmesh, jspecs[key]).spec)
                assert sharding.batch_shardings(mesh, specs[key]).spec == want, key
        # A 0-d leaf is replicated.
        assert sharding.batch_shardings(mesh, torch.zeros(())).spec == ()


# ---------------------------------------------------------------------------
# Rule tables
# ---------------------------------------------------------------------------

class TestRules:
    @pytest.mark.parametrize("mesh_name", list(MESHES))
    def test_rule_tables_equal_the_references(self, mesh_name):
        jmesh, mesh = _meshes(mesh_name)
        assert sharding.train_rules(mesh) == jsh.train_rules(jmesh)
        assert sharding.decode_rules(mesh) == jsh.decode_rules(jmesh)
        assert sharding.batch_axes(mesh) == jsh.batch_axes(jmesh)
        assert sharding.fsdp_axis(mesh) == jsh.fsdp_axis(jmesh)

    def test_train_vs_decode_cache_axis(self):
        _, mesh = _meshes("16x16")
        assert sharding.train_rules(mesh)["cache_seq"] is None
        assert sharding.decode_rules(mesh)["cache_seq"] == "model"


# ---------------------------------------------------------------------------
# Shapes, input specs and configs
# ---------------------------------------------------------------------------

class TestInputSpecs:
    def test_shapes_equal_the_references(self):
        assert SHAPE_IDS == jax_shapes.SHAPE_IDS
        for key, shape in SHAPES.items():
            assert dataclasses.astuple(shape) == dataclasses.astuple(jax_shapes.SHAPES[key])

    @pytest.mark.parametrize("name", ARCH_IDS)
    def test_the_long_500k_gate_and_every_input_shape_equal_the_references(self, name):
        jcfg, cfg = jax_get_config(name), get_config(name)
        for key, shape in SHAPES.items():
            jshape = jax_shapes.SHAPES[key]
            assert shape_applicable(cfg, shape) == jax_shapes.shape_applicable(jcfg, jshape)
            if key == "long_500k" and not shape_applicable(cfg, shape):
                continue
            jspecs, specs = jax_shapes.input_specs(jcfg, jshape), input_specs(cfg, shape)
            assert set(specs) == set(jspecs), key
            for k in specs:
                if k == "caches":
                    got = [tuple(t.shape) for layer in specs[k] for t in layer.values()]
                    assert sum(int(np.prod(s)) for s in got) == sum(
                        int(np.prod(t.shape)) for t in jax.tree.leaves(jspecs[k]))
                elif k == "pos":
                    assert specs[k] == shape.seq_len - 1 and jspecs[k].shape == ()
                else:
                    assert tuple(specs[k].shape) == tuple(jspecs[k].shape), (key, k)
                    assert specs[k].device.type == "meta"

    def test_the_references_named_cases(self):
        qwen = get_config("qwen3-0.6b")
        specs = input_specs(qwen, SHAPES["train_4k"])
        assert specs["tokens"].shape == (256, 4096) and specs["labels"].dtype == torch.int32
        specs = input_specs(qwen, SHAPES["decode_32k"])
        assert specs["token"].shape == (128, 1) and "caches" in specs
        specs = input_specs(get_config("llama-3.2-vision-90b"), SHAPES["train_4k"])
        assert specs["media"].shape == (256, 1601, 1280)
        assert not shape_applicable(qwen, SHAPES["long_500k"])
        for name in ("xlstm-1.3b", "gemma3-27b", "jamba-1.5-large-398b"):
            assert shape_applicable(get_config(name), SHAPES["long_500k"])


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("name", ARCH_IDS)
def test_every_config_field_equals_the_references(name):
    """Every ArchConfig field of the published and the smoke config,
    ``supports_long_context`` and ``max_seq_len`` included; layer specs by
    their fields."""
    for port, ref in ((get_config(name), jax_get_config(name)),
                      (get_smoke_config(name), jax_get_smoke(name))):
        got, want = _fields(port), _fields(ref)
        assert set(got) == set(want)
        for key in want:
            if key in ("pattern", "remainder"):
                assert [dataclasses.astuple(s) for s in got[key]] == [
                    dataclasses.astuple(s) for s in want[key]], key
            else:
                assert got[key] == want[key], key
        assert port.param_count() == ref.param_count()


# ---------------------------------------------------------------------------
# Logical-axis context
# ---------------------------------------------------------------------------

class TestShardingContext:
    def test_shard_is_the_identity_outside_a_context_and_on_plain_tensors(self):
        x = torch.zeros(2, 3)
        assert ctx.shard(x, "batch", "embed") is x
        assert ctx.gather_tree({"w": x})["w"] is x and ctx.replicate(x) is x
        _, mesh = _meshes("16x16")
        with ctx.logical_sharding(mesh, sharding.train_rules(mesh)):
            assert ctx.shard(x, "batch", "embed") is x
            assert ctx.gather_fsdp({"w": x})["w"] is x
            with pytest.raises(ValueError, match="rank-2"):
                ctx.shard(x, "batch")

    def test_context_is_restored_and_seen_by_other_threads(self):
        """Process-wide: autograd's device thread recomputes checkpointed
        code under the step's rules."""
        _, mesh = _meshes("2x16x16")
        rules = sharding.decode_rules(mesh)
        seen = []
        with ctx.logical_sharding(mesh, rules):
            assert ctx.logical_to_spec(("batch", "cache_seq", None)) == (
                ("pod", "data"), "model", None)
            assert ctx.get_rule("ff") == "model" and ctx.get_rule("xlstm_gather_params") is None
            t = threading.Thread(target=lambda: seen.append(ctx.get_rule("ff", "none")))
            t.start()
            t.join(timeout=10)
            with pytest.raises(RuntimeError):
                with ctx.logical_sharding(mesh, {**rules, "ff": None}):
                    assert ctx.get_rule("ff") is None
                    raise RuntimeError
            assert ctx.get_rule("ff") == "model"
        assert seen == ["model"] and ctx.get_rule("ff") is None

    def test_spec_to_placements(self):
        _, mesh = _meshes("2x16x16")
        assert ctx.spec_to_placements(mesh, (("pod", "data"), None, "model")) == (
            Shard(0), Shard(0), Shard(2))
        assert ctx.spec_to_placements(mesh, (None, None)) == (Replicate(),) * 3
        with pytest.raises(ValueError, match="twice"):
            ctx.spec_to_placements(mesh, ("model", "model"))
        with pytest.raises(ValueError, match="not a dim"):
            ctx.spec_to_placements(mesh, ("expert",))
        assert AbstractMesh((2, 16, 16), ("pod", "data", "model")).size() == 512


# ---------------------------------------------------------------------------
# Collective, FLOP and memory accounting
# ---------------------------------------------------------------------------

class TestAccounting:
    def test_collective_bytes_on_the_references_inventory(self):
        """``test_launch.py::TestHLOParsing::test_parse_collectives``'
        inventory: the same totals, exactly."""
        colls = [{"kind": "all-gather", "result_bytes": 32 * 128 * 4, "group": 4},
                 {"kind": "all-reduce", "result_bytes": 64 * 2, "group": 8},
                 {"kind": "collective-permute", "result_bytes": 16 * 4, "group": 1}]
        total, by_kind = collective_bytes_per_device(colls)
        assert (total, by_kind) == jax_collective_bytes(colls)
        assert np.isclose(total, 32 * 128 * 4 * 3 / 4 + 2 * 64 * 2 * 7 / 8 + 16 * 4)

    @pytest.mark.parametrize("kind", ["all-gather", "all-reduce", "reduce-scatter",
                                      "all-to-all", "collective-permute", "broadcast"])
    @pytest.mark.parametrize("group", [1, 2, 16])
    def test_every_kind_equals_the_references_formula(self, kind, group):
        colls = [{"kind": kind, "result_bytes": 4096, "group": group}] * 3
        assert collective_bytes_per_device(colls) == jax_collective_bytes(colls)

    def test_step_counter_counts_matmul_flops_and_live_bytes(self):
        a, b = torch.ones(64, 32), torch.ones(32, 16)
        counter = StepCounter()
        counter.hold((a, b))
        with counter:
            c = a @ b                               # 64x16 fp32 kept
            d = (c * 2).sum()                       # a 64x16 temporary, freed
        summary = summarize(counter, (a, b), (c, d))
        assert summary["flops"] == 2 * 64 * 32 * 16
        assert summary["argument_bytes_per_device"] == (64 * 32 + 32 * 16) * 4
        assert summary["peak_bytes_per_device"] == (64 * 32 + 32 * 16 + 2 * 64 * 16) * 4 + 4
        assert summary["n_collectives"] == 0 and summary["collective_bytes_per_device"] == 0.0


_SIXTEEN = """
import sys
from repro_torch.launch import dryrun
runs = [["--shape", "train_4k", "--batch", "32", "--seq", "64", "--probe-repeats", "1"],
        ["--shape", "prefill_32k", "--batch", "16", "--seq", "64", "--probe-repeats", "1"],
        ["--shape", "decode_32k", "--batch", "16", "--seq", "64", "--probe-repeats", "1"],
        ["--shape", "long_500k"]]
sys.exit(max(dryrun.main(["--smoke", "--arch", "qwen3-0.6b", "--out-dir", sys.argv[1], *r])
             for r in runs))
"""

REFERENCE_KEYS = {"arch", "shape", "variant", "mesh", "chips", "probe_repeats", "status",
                  "lower_s", "compile_s", "param_count", "active_param_count", "flops",
                  "argument_bytes_per_device", "output_bytes_per_device",
                  "temp_bytes_per_device", "alias_bytes_per_device", "peak_bytes_per_device",
                  "collective_bytes_per_device", "collective_breakdown", "n_collectives"}


def test_dryrun_on_the_fake_16x16_mesh_writes_the_references_records(tmp_path):
    """Train, prefill and decode of smoke qwen3 on the production mesh,
    and the skipped long_500k pair of a full-attention arch, in one child
    process (each run starts and destroys its fake process group)."""
    proc = subprocess.run([sys.executable, "-c", _SIXTEEN, str(tmp_path)], env=ENV, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        assert f"[dryrun] qwen3-0.6b__{shape}__16x16__probe1: ok flops=" in proc.stdout
        rec = json.loads((tmp_path / f"qwen3-0.6b__{shape}__16x16__probe1.json").read_text())
        assert REFERENCE_KEYS <= set(rec) and rec["chips"] == 256 and rec["mesh"] == "16x16"
        assert rec["flops"] > 0 and rec["n_collectives"] > 0
        assert rec["collective_bytes_per_device"] == pytest.approx(
            sum(rec["collective_breakdown"].values()))
    skipped = json.loads((tmp_path / "qwen3-0.6b__long_500k__16x16.json").read_text())
    assert skipped["status"] == "skipped"
