"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level names; the reference and the generators load nothing of the port."""
import json
import os
import subprocess
import sys

from conftest import ROOT

CHECK = r"""
import json, os, sys
sys.argv = ["run.py"]
sys.path[0] = {root!r}
import importlib.util
spec = importlib.util.spec_from_file_location("portbench_run", os.path.join({root!r}, "portbench", "run.py"))
run = importlib.util.module_from_spec(spec); spec.loader.exec_module(run)
from portbench import harness, reference, tracing
from portbench.roofline import counts, peaks
spec = harness.load_json(os.path.join({root!r}, "BENCHMARK.json"))
for w in spec["workloads"]:
    cell = harness.Cell.load({root!r}, w["name"])
    fam = cell.module("families", cell.config["family"] + ".py")
    cell.module("port", fam.KIND + "_qp.py")
    for m in cell.end_to_end() + cell.per_layer():
        cell.module("metrics", m["name"] + ".py")
import galahad_tpu_torch.qp.ipm, galahad_tpu_torch.qp.fused
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""

PLAIN = r"""
import json, sys
sys.path[0] = {root!r}
from portbench import reference
from portbench.families import banded_lp, ept_torsion
from portbench.roofline import counts, grid_elimination, peaks
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def loaded(code: str) -> set:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT)], env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_jax_and_no_jax_package():
    tops = loaded(CHECK)
    assert "galahad_tpu_torch" in tops and "portbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "galahad_tpu"}, tops


def test_the_reference_loads_nothing_of_the_port():
    tops = loaded(PLAIN)
    assert not tops & {"galahad_tpu_torch", "galahad_tpu", "jax"}, tops


def test_the_harness_names_what_it_finds():
    import galahad_tpu_torch  # noqa: F401  (its name begins with the JAX package's)
    from portbench import harness

    assert harness.forbidden_modules() == []
    for name in ("galahad_tpu", "jax"):
        sys.modules[name] = type(sys)(name)
        try:
            assert harness.forbidden_modules() == [name]
        finally:
            del sys.modules[name]
