"""The port's command line (``python -m galahad_tpu_torch solve|batch``,
galahad_tpu_torch/cli.py) on the CPU (``--device cpu``), held to the front
end's oracle tests/frontend_sweep_oracle.json (the JAX package's
``qp_solve(read_qp(f), QPControl())``, made by tools/make_frontend_oracle.py).

What is held: on each fixture run, the status and iteration count equal the
oracle's and the objective is within 1e-8 relative (``solve --json`` and the
``batch`` RES.d lines over all 20 fixtures of examples/sweep/sweep.list);
QPDEGEN and QPMIXB are the two that the DQP rescue answers.  The text output and its
footer, ``--solution-file``, ``--spec``, an ``ERROR`` line for a bad file,
the default device (the card: an error here) and ``python -m``.  One fixture
is also solved live by the JAX package, and must give the file's values, so
that a stale oracle shows."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from galahad_tpu_torch import cli

from _torch_port_helpers import REPO, SWEEP, one_torch_thread, sweep_path  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

with open(os.path.join(REPO, "tests", "frontend_sweep_oracle.json")) as _fh:
    ORACLE = json.load(_fh)["fixtures"]

with open(os.path.join(REPO, "examples", "sweep", "sweep.list")) as _fh:
    SWEEP_LIST = [ln.strip() for ln in _fh if ln.strip() and not ln.startswith("#")]


def check_result(name, status, iters, obj):
    ref = ORACLE[name]
    assert (status, iters) == (ref["status"], ref["iter"]), name
    assert abs(obj - ref["obj"]) <= 1e-8 * max(1.0, abs(ref["obj"])), name


def test_oracle_covers_the_sweep():
    assert sorted(ORACLE) == SWEEP and len(SWEEP) == 20
    rescued = sorted(k for k, v in ORACLE.items() if v["solver"] == "dqp")
    assert rescued == ["QPDEGEN", "QPMIXB"]


def test_solve_json(capsys):
    rc = cli.main(["solve", sweep_path("QPMIXB"), "--json", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["name"] == "QPMIXB" and (out["n"], out["m"]) == (160, 70)
    check_result("QPMIXB", out["status"], out["iterations"], out["objective"])
    assert set(out) == {"name", "n", "m", "status", "status_name", "objective",
                        "primal_infeasibility", "dual_infeasibility",
                        "complementary_slackness", "iterations", "time"}
    assert max(out["primal_infeasibility"], out["dual_infeasibility"]) <= 1e-6


def test_text_footer_and_solution_file(tmp_path, capsys):
    sol = tmp_path / "sol.txt"
    rc = cli.main(["solve", sweep_path("QPB100"), "--device", "cpu",
                   "--solution-file", str(sol)])
    text = capsys.readouterr().out
    assert rc == 0
    assert " status         0 (OK)" in text and " solver         cqp" in text
    assert " factorizations " in text and " phase times    preprocess" in text
    assert " checkpoints    1e-1:" in text
    lines = sol.read_text().splitlines()
    assert lines[0].startswith("QPB100 status 0 objective ")
    assert lines[1] == "x 100"
    x = np.array([float(v) for v in lines[2:102]])
    assert np.abs(x - np.asarray(ORACLE["QPB100"]["x"])).max() <= 1e-6
    assert "y 50" in lines and "z 100" in lines


def test_spec_overrides_the_ipm_control(tmp_path, capsys):
    spec = tmp_path / "RUNCQP.SPC"
    spec.write_text("maxit 3\n")
    rc = cli.main(["solve", sweep_path("LPB100"), "--spec", str(spec), "--json",
                   "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1 and (out["status"], out["iterations"]) == (-18, 3)


def test_batch_against_the_oracle(tmp_path):
    """examples/sweep/sweep.list (all 20 fixtures, among them QPDEGEN and QPMIXB,
    which the rescue answers, and LPWIDE, which stays at -5), then a missing
    file."""
    lst, res = tmp_path / "list.txt", tmp_path / "RES.d"
    lst.write_text("# a comment\n" + "\n".join(os.path.join(REPO, p) for p in SWEEP_LIST)
                   + "\n" + str(tmp_path / "missing.qplib") + "\n")
    rc = cli.main(["batch", str(lst), "--out", str(res), "--device", "cpu"])
    lines = res.read_text().splitlines()
    assert rc == 1 and len(lines) == len(SWEEP_LIST) + 1 == 21
    for path, line in zip(SWEEP_LIST, lines):
        name = os.path.basename(path)[:-len(".qplib")]
        f = line.split()
        assert f[0] == name and int(f[1]) == len(ORACLE[name]["x"])
        check_result(name, int(f[3]), int(f[8]), float(f[4]))
    assert lines[-1].split()[1:3] == ["ERROR", "FileNotFoundError:"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_the_default_device_is_the_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["solve", sweep_path("QPEQ")])


def test_python_dash_m():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "galahad_tpu_torch", "solve",
                          sweep_path("QPDEGEN"), "--json", "--device", "cpu"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    r = json.loads(out.stdout.splitlines()[-1])
    check_result("QPDEGEN", r["status"], r["iterations"], r["objective"])


def test_oracle_is_current():
    """The JAX package, run now on QPMIXB, still gives the file's solver,
    status, iterations, objective and x."""
    from galahad_tpu.io import qplib as j_qplib
    from galahad_tpu.qp.dqp import DQPInfo
    from galahad_tpu.qp.frontend import QPControl, qp_solve

    qp = j_qplib.read_qp(sweep_path("QPMIXB"))
    x, _, _, info = qp_solve(qp, QPControl())
    ref = ORACLE["QPMIXB"]
    assert isinstance(info, DQPInfo) and ref["solver"] == "dqp"
    assert (int(info.status), int(info.iter)) == (ref["status"], ref["iter"])
    assert abs(float(qp.objective(x)) - ref["obj"]) <= 1e-12 * abs(ref["obj"])
    assert np.abs(np.asarray(x) - np.asarray(ref["x"])).max() <= 1e-12
