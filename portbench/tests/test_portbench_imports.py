"""Nothing the harness loads has ``jax``, ``jaxlib``, ``flax``, ``repro``
or ``benchmarks`` as its top-level module name (names compared whole:
``repro_torch`` is the system under test), and the plain reference loads
nothing of the port."""
import os
import subprocess
import sys

from portbench.common import ROOT

HARNESS = """
import sys
for name in ("jax", "jaxlib", "flax", "repro", "benchmarks"):
    sys.modules[name] = None
sys.path[:0] = [{src!r}, {root!r}]
import importlib, pathlib
for mod in ("portbench.run", "portbench.serving", "portbench.training",
            "portbench.checks", "portbench.sweep", "portbench.trace", "portbench.readers"):
    importlib.import_module(mod)
from portbench.common import FORBIDDEN_MODULES, load_reader, manifest
for m in manifest()["per_layer"]:
    load_reader(m["name"])
import repro_torch.launch.serve, repro_torch.launch.steps  # what the runners load at set-up
bad = sorted({{n.split(".")[0] for n, v in sys.modules.items()
              if v is not None and n.split(".")[0] in FORBIDDEN_MODULES}})
print("BAD", bad)
"""

REFERENCE = """
import sys
sys.path[:0] = [{root!r}]
import portbench.reference.model, portbench.reference.router, portbench.reference.optim
print("PORT", sorted({{n for n in sys.modules if n.split(".")[0] in ("repro_torch", "repro", "jax")}}))
"""


def _run(code: str) -> str:
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, "-c", code.format(src=str(ROOT / "src"),
                                                             root=str(ROOT))],
                          capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_harness_loads_no_jax_nor_the_jax_package():
    assert "BAD []" in _run(HARNESS)


def test_reference_imports_nothing_of_the_port():
    assert "PORT []" in _run(REFERENCE)


def test_forbidden_names_are_compared_whole():
    from portbench.common import forbidden_loaded
    mod = object()
    assert forbidden_loaded({"repro_torch": mod, "repro_torch.models.lm": mod,
                             "jaxtyping": mod, "reprox": mod, "benchmarks_x": mod}) == []
    assert forbidden_loaded({"repro.core.router": mod, "jax.numpy": mod,
                             "benchmarks.run": mod, "flax": None}) == ["benchmarks", "jax", "repro"]
