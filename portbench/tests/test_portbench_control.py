"""The control reads not correct: the reference in the program's place one
precision below the configuration's (TF32 for the f32 configuration, int4
linears for the int8 one, and the int8 one's linears with TF32 elsewhere), judged by each cell's own comparison and
limits, on three seeds: the cell's configuration at its widths, its
traffic's shortest texts and two requests a seed. TF32 exists only on the
card, so this runs there (`python3 -m pytest -m cuda portbench/tests`); the
readings at each cell's own sizes come from `portbench/control.py`."""

import pytest
import torch

import portbench.control as C
import portbench.run as R

CASES = [("base.offline-b16", "below"), ("int8.offline-b16", "below"), ("int8.offline-b16", "tf32")]


@pytest.mark.cuda
@pytest.mark.parametrize("workload,kind", CASES)
def test_control_is_not_correct(workload, kind):
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 needs a CUDA device")
    _, conf, traffic, limits, _, _ = R.cell(workload)
    lo = traffic["tokens"][0]
    traffic = dict(traffic, tokens=[lo, lo + 60], calibrate=4, check_sample=2)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        got = C.readings(conf, traffic, seed, "cuda", kind=kind)["whole"]
        assert any(got[k] > v for k, v in limits["limits"].items()), (seed, got)
