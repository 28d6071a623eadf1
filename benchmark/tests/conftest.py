"""Shared set-up of the benchmark's tests: the repository on the path,
one torch thread, and tiny versions of the cells' files."""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True)
def one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cell(name: str, **over):
    """The cell `name` at a size the CPU runs in seconds: 2,000
    Gaussians, 64x64 (recon 80x48) views, 8 cameras, the kernels' plain
    versions on the CPU."""
    import time

    import torch

    from benchmark import run, workload

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    _, cfg, tr, cellf = run.cell_files(bench, name)
    cfg, tr = copy.deepcopy(cfg), copy.deepcopy(tr)
    sc = cfg["scene"]
    sc["capacity"] = 2000 if sc["capacity"] == sc["n_gaussians"] else 8000
    sc["n_gaussians"] = 2000
    cam = cfg["cameras"]
    cam["height"], cam["width"] = (48, 80) if "recon" in cfg else (64, 64)
    for r in cam["rings"]:
        r["count"] = 4
    if "train" in cfg:
        cfg["train"]["max_view_num"] = 8
    if tr["driver"] == "webui":
        tr["size"] = 64
    args = dict(name=name, cfg=cfg, traffic=tr, limits=cellf["limits"],
                seed=2 ** 31 + 5, seconds=0.5, trace=False,
                device=torch.device("cpu"), t_start=time.perf_counter())
    args.update(over)
    return workload.Cell(**args)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, not at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
