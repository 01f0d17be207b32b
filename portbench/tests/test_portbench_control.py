"""The precision controls of each configuration come out not correct: the
reference computed in bfloat16 in TV-1D's place (on the CPU), and for the
graphical lasso both the program with its TF32 path on and the reference
computed with TF32 products in its place (on the card: the CPU has no
TF32)."""

import time

import pytest

from portbench import faults, harness, readings
from portbench.tests.tiny import tiny_cell


def test_tv1d_control_is_not_correct():
    cell = tiny_cell("tv1d_1m.signal_stream")
    assert [c["mode"] for c in cell.config["check"]["controls"]] == ["reference_bf16"]
    checks = readings.control_from_reference(cell, 2**31 + 9, device="cpu")
    assert any(v > limit for v, limit in checks.values())


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _covsel_cell():
    cell = tiny_cell("covsel_1000.lambda_path")
    cell.config["p"] = 200
    assert [c["mode"] for c in cell.config["check"]["controls"]] == ["program_tf32",
                                                                    "reference_tf32"]
    return cell


@pytest.mark.cuda
def test_covsel_control_is_not_correct_on_the_card(cuda, monkeypatch):
    cell = _covsel_cell()
    result, _ = harness.run_cell(cell, 2**31 + 11, 2.0, False, time.perf_counter())
    assert result["correct"] is True
    faults.program_tf32(monkeypatch.setattr)
    try:
        result, checks = harness.run_cell(cell, 2**31 + 11, 2.0, False, time.perf_counter())
    except RuntimeError as e:
        # TF32 can keep the solve from its tolerance: the warm-up request
        # fails, and the run ends with no result
        assert "warm-up request failed" in str(e)
        return
    assert result["correct"] is False
    assert result["failed"] or any(v > limit for v, limit in checks.values())


@pytest.mark.cuda
def test_covsel_reference_control_is_not_correct_on_the_card(cuda):
    checks = readings.control_from_reference(_covsel_cell(), 2**31 + 13)
    assert any(v > limit for v, limit in checks.values())
