"""A copy of the benchmark in a temporary root with small cells of both
families added as new files and entries, for runs on the CPU."""
import json
import os
import shutil

from conftest import ROOT

TINY = {"grid-tiny": ("ept-torsion-700", {"nx": 8, "ny": 7}),
        "band-tiny": ("lpband-1m", {"n": 64})}


def tiny_root(tmp: str) -> str:
    """``tmp`` with BENCHMARK.json and portbench/ copied from the repository,
    plus the configurations ``grid-tiny`` and ``band-tiny`` and the cells
    ``grid-tiny.mehrotra``, ``grid-tiny.taylor4`` and ``band-tiny.resolve``."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp)
    shutil.copytree(os.path.join(ROOT, "portbench"), os.path.join(tmp, "portbench"),
                    ignore=shutil.ignore_patterns("_cache", "_runs", "__pycache__"))
    spec = json.load(open(os.path.join(tmp, "BENCHMARK.json")))
    for name, (parent, change) in TINY.items():
        conf = next(c for c in spec["configs"] if c["name"] == parent)
        body = json.load(open(os.path.join(ROOT, conf["file"])))
        body.update(change)
        path = f"portbench/configs/{name}.json"
        with open(os.path.join(tmp, path), "w") as fh:
            json.dump(body, fh)
        spec["configs"].append(dict(conf, name=name, file=path, reduced=sorted(change)))
    cells = [("grid-tiny.mehrotra", "grid-tiny", "mehrotra"),
             ("grid-tiny.taylor4", "grid-tiny", "taylor4"),
             ("band-tiny.resolve", "band-tiny", "mehrotra")]
    for name, conf, traffic in cells:
        spec["workloads"].append(dict(name=name, config=conf, traffic=traffic, chips=1,
                                      why="a small copy for the CPU"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [c[0] for c in cells]
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    return tmp
