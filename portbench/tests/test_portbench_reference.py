"""The plain reference against the port at a small width on the CPU: whole
runs of each cell, with the port's CPU paths (kernels 1 and 2 in
their plain versions), judged by the cell's own comparison and limits."""

import pytest
import torch

import portbench.run as R
from portbench.tests.small import adjust, adjust_long


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


CASES = [("base.offline-b16", adjust), ("int8.offline-b16", adjust), ("base.offline-b16", adjust_long)]


@pytest.mark.parametrize("workload,size", CASES, ids=["base", "int8", "long-route"])
def test_reference_agrees_with_the_port(workload, size):
    res = R.evaluate(workload, 2 ** 31 + 77, 1.0, 0, device="cpu", adjust=size)
    assert res["attempted"] > 0 and res["failed"] == 0
    for name, c in res["checks"].items():
        assert c["value"] <= c["limit"], (name, c)
    assert res["correct"]
