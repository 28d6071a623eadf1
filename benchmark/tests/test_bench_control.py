"""The control: the reference in TF32 put in the program's place must
come out not correct. On the card only (TF32 does nothing on the CPU);
at a size a test run holds. `--control 1 --check-seeds ...` reads it at
the cells' own sizes."""

import pytest

from benchmark import run, workload
from conftest import tiny_cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["edit1m", "garden-late", "webui-edit1m"])
def test_the_control_is_not_correct(name, cuda_device):
    cell = tiny_cell(name, device=cuda_device, control=True)
    cell.cfg["scene"]["n_gaussians"] = cell.cfg["scene"]["capacity"] = 200_000
    cam = cell.cfg["cameras"]
    cam["height"], cam["width"] = 256, 256
    if cell.traffic["driver"] == "webui":
        cell.traffic["size"] = 256
    for seed in (1, 2, 3):
        cell.seed = seed
        r = workload.driver(cell.traffic["driver"])(cell)
        assert not run.judge(r, cell.limits)[0], r.checks
