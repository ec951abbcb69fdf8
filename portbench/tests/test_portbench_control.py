"""``correct`` comes out false for the control (the program in the precision
below the configuration's) and for each fault a cell of one problem a request
can have: a step that returns its state unchanged, and an answer altered where
it is produced; on the banded path also for a Schur complement solved with its
coupling between block rows left out.  The harness's look for a chip is
skipped: the run is driven on the CPU at a small size, with the timed path
broken underneath."""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import ROOT
from portbench import harness
from tiny import tiny_root

SEED = 2 ** 31 + 101
CELLS = ("grid-tiny.mehrotra", "grid-tiny.taylor4", "band-tiny.resolve")


def quiet(msg):
    pass


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(root, cell):
    out = harness.run_cell(root, cell, SEED, 0.5, False, "cpu", log=quiet)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(root, cell):
    out = harness.run_cell(root, cell, SEED, 0.5, False, "cpu", control="lower_precision",
                           log=quiet)
    assert not out["correct"] and out["failed"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_changes_nothing(root, cell, monkeypatch):
    """The iterate comes back unchanged; only the iteration count moves (with
    it unchanged too the host loop, which stops on the state's count, would
    never end)."""
    from galahad_tpu_torch.qp import ipm

    monkeypatch.setattr(ipm, "ipm_step", lambda qp, masks, st, ctl, escalate=False:
                        dataclasses.replace(st, iter=st.iter + 1))
    out = harness.run_cell(root, cell, SEED, 0.2, False, "cpu", log=quiet)
    assert not out["correct"] and out["failed"] == out["attempted"]


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced(root, cell, monkeypatch):
    from galahad_tpu_torch.qp import ipm

    real = ipm.extract_solution

    def altered(qp, masks, st):
        x, y, z = real(qp, masks, st)
        return x + 1e-4 * (torch.arange(x.numel(), dtype=x.dtype) % 3 == 0), y, z

    monkeypatch.setattr(ipm, "extract_solution", altered)
    out = harness.run_cell(root, cell, SEED, 0.2, False, "cpu", log=quiet)
    assert not out["correct"]


def test_a_banded_solve_that_drops_the_coupling(root, monkeypatch):
    """The block-tridiagonal solve of the Schur complement with its
    off-diagonal factor blocks taken as zero: each direction is wrong where
    the active rows couple."""
    from galahad_tpu_torch.linalg import banded
    from galahad_tpu_torch.qp import ipm_banded

    real = ipm_banded.block_tridiag_solve

    def uncoupled(f, rhs):
        return real(dataclasses.replace(f, Lo=torch.zeros_like(f.Lo)), rhs)

    assert dataclasses.is_dataclass(banded.BlockTridiagFactors)
    monkeypatch.setattr(ipm_banded, "block_tridiag_solve", uncoupled)
    out = harness.run_cell(root, "band-tiny.resolve", SEED, 0.2, False, "cpu", log=quiet)
    assert not out["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ("ept-torsion-700.mehrotra", "lpband-1m.resolve"))
def test_on_the_card_the_control_fails_at_the_cells_size(cell):
    """The control on the card at the cell's own size (the benchmark's own runs do
    not run it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for control, want in ((["--control", "lower_precision"], False), ([], True)):
        out = subprocess.run(
            [sys.executable, os.path.join(ROOT, "portbench", "run.py"), "--workload", cell,
             "--seed", str(SEED), "--seconds", "5", "--trace", "0", *control],
            cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is want
