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


# --- hand-made profiler events and program spans ---

MAIN, IDENT, AUTOGRAD, HANDLER = 100, 0x7F00AA, 101, 0xA79FF6C0


class Ev:
    """A `_KinetoEvent` stand-in."""

    def __init__(self, name, start, dur, dev, corr, key):
        self._v = (name, start, dur, dev, corr, key)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def correlation_id(self):
        return self._v[4]

    def device_resource_id(self):
        return self._v[5]


def kernel(name, launch_at, key, start, dur, corr):
    """A runtime launch on thread `key` and the device work it starts."""
    return [Ev("cudaLaunchKernel", launch_at, 5, False, corr, key),
            Ev(name, start, dur, True, corr, 7)]


def sp(name, start, end, id, parent=None, tid=MAIN, ident=IDENT, rid=0):
    from gaussianeditor_tpu_torch.utils.profiling import Span

    return Span(name, start, end, id, parent, tid, ident, rid)


def step_spans():
    return [
        sp("edit.step", 0, 1000, 1),
        sp("train.step", 10, 900, 2, 1),
        sp("render", 20, 200, 3, 2),
        sp("render.bin", 50, 150, 4, 3),
        sp("sync.num_rendered", 60, 100, 5, 4),
        sp("train.backward", 300, 600, 6, 2),
        sp("composite.backward", 350, 380, 7, None, AUTOGRAD, 0x99),
        sp("train.optim", 650, 850, 8, 2),
        sp("bin.key", 105, 145, 9, 4),
    ]


def step_events():
    """B1 under `bin.key`, Adam under `train.optim` (launched by the
    pthread id), a fill after `render` ended, and a memset with no
    launch."""
    return (kernel("binning_key_kernel", 120, MAIN, 130, 10, 1)
            + kernel("adam", 700, IDENT, 710, 30, 2)
            + kernel("fill", 205, MAIN, 210, 4, 3)
            + kernel("other_thread", 120, 555, 220, 6, 4)
            + [Ev("Memset", 900, 2, True, 99, 7)])
