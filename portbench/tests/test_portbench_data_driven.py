"""A configuration, a traffic mix and a per-layer metric added as new files
plus entries in BENCHMARK.json are found and run by the harness, at a small
size on the CPU, with no file of the benchmark edited."""
import hashlib
import json
import os

from portbench import harness
from tiny import tiny_root

NEW_METRIC = '''"""Requests the window completed."""


def read(run):
    return float(len(run.requests))
'''


def digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "portbench")):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_files_and_entries_are_enough(tmp_path):
    root = tiny_root(str(tmp_path))
    before = digests(root)
    with open(os.path.join(root, "portbench/traffic/fetch2.json"), "w") as fh:
        json.dump(dict(loop="closed", clients=1,
                       control=dict(steps_per_fetch=2), trace_requests=1), fh)
    with open(os.path.join(root, "portbench/configs/grid-six.json"), "w") as fh:
        body = json.load(open(os.path.join(root, "portbench/configs/ept-torsion-700.json")))
        json.dump(dict(body, nx=6, ny=6), fh)
    with open(os.path.join(root, "portbench/metrics/requests_in_window.py"), "w") as fh:
        fh.write(NEW_METRIC)
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    spec["configs"].append(dict(name="grid-six", source=body["source"],
                                file="portbench/configs/grid-six.json", reduced=["nx", "ny"],
                                why="a small grid"))
    spec["workloads"].append(dict(name="grid-six.fetch2", config="grid-six", traffic="fetch2",
                                  chips=1, why="two steps a fetch"))
    spec["per_layer"].append(dict(name="requests_in_window", unit="requests", better="higher",
                                  source="program_counter", layer="IPM host loop",
                                  moves="solve_s", workloads=["grid-six.fetch2"]))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)

    e2e = harness.run_cell(root, "grid-six.fetch2", 2 ** 31 + 3, 0.5, False, "cpu",
                           log=lambda msg: None)
    assert e2e["correct"] and e2e["attempted"] >= 1
    assert set(e2e["metrics"]) == {"solve_s", "setup_s"}
    layer = harness.run_cell(root, "grid-six.fetch2", 2 ** 31 + 3, 0.5, True, "cpu",
                             log=lambda msg: None)
    assert layer["correct"]
    assert layer["metrics"]["requests_in_window"]["value"] >= 1
    assert layer["metrics"]["requests_in_window"]["unit"] == "requests"
    assert "iterations_per_solve" not in layer["metrics"]       # not listed for this cell
    assert list(layer)[-1] == "checks"
    after = digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
