"""The check that decides `correct`: a run with a planted fault in the
program's timed path reads not correct (CPU, small sizes), and on the card
the control (the reference one precision step down, in the program's
place, in each of the configuration's lower precisions) fails the cell's
limits at the cell's own size."""

import json
from pathlib import Path

import pytest
from conftest import TINY_SERVE, TINY_TRAIN

import calibrate
import run
from lib import faults

BENCH = Path(__file__).resolve().parents[1]


def limits(workload):
    return json.loads((BENCH / "limits" / f"{workload}.json").read_text())


def fails(readings: dict, workload: str) -> bool:
    return any(not readings[k] <= v for k, v in limits(workload).items())


def test_an_altered_frame_is_not_correct():
    r = run.run_cell("diner_dtu.sweep", 11, 1.0, False, device="cpu",
                     overrides=TINY_SERVE,
                     fault=faults.FAULTS["frame_altered"])
    assert r["correct"] is False


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_training_step_is_not_correct(dtu_tree, fault):
    r = run.run_cell("diner_dtu.train_b4", 12, 1.0, False, device="cpu",
                     overrides=TINY_TRAIN, fault=faults.FAULTS[fault])
    assert r["correct"] is False


def test_a_sound_training_run_is_correct(dtu_tree):
    r = run.run_cell("diner_dtu.train_b4", 2 ** 31 + 13, 1.0, True,
                     device="cpu", overrides=TINY_TRAIN)
    assert r["correct"] is True, r["checks"]
    assert r["metrics"]["train.loader_wait_ms"]["value"] >= 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["diner_dtu.sweep",
                                      "diner_facescape.sweep",
                                      "diner_dtu.train_b4"])
def test_the_control_fails_the_limits_on_the_card(cuda, workload):
    for seed in (2_000_000_101, 2_000_000_102, 2_000_000_103):
        r = calibrate.readings(workload, seed, 3.0, True)
        assert not fails(r["program"], workload), r
        for name, control in r["controls"].items():
            assert fails(control, workload), (name, r)
