"""Build, load and launch the hand-written CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` holds one kernel behind a plain C entry point
`int <name>(...)` that launches on the given stream and returns
`cudaGetLastError()`, plus `const char* <name>_error_string(int)`. At
first use every source is compiled by its own `nvcc` process, all started
together, into `build/kernels/lib<name>-<digest>.so` beside the package
(the directory is git-ignored); the digest covers the source and the
flags, so an edited source is rebuilt. The libraries are loaded with
`ctypes`. Nothing is compiled at import time, and nothing but the
repository's own sources is built.

Every launch adds one to that kernel's count in `LAUNCHES`; a caller
shows that a path went through the kernels by zeroing the counts with
`reset_launch_counts()` before it and reading `launch_counts()` after.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# C signature of each kernel's entry point (all pointers and the stream
# as c_void_p, so that 64-bit addresses are never cut)
SIGNATURES = {
    # b_incl, tiles_touched, rect_min, rect_max, mean2d, conic, opacity,
    # depth, color, C, ch, n, total, grid_x, depth_bits, key, payload,
    # stream
    "binning_key": (_P,) * 9 + (_I,) * 6 + (_P, _P, _P),
    # bounds, payload, n, num_tiles, grid_x, ch, color, depth, final_T,
    # n_contrib, stream
    "forward_tile": (_P, _P, _L, _I, _I, _I, _P, _P, _P, _P, _P),
}

LAUNCHES: Dict[str, int] = {name: 0 for name in SIGNATURES}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: `$CUDA_HOME/bin/nvcc`, else `nvcc` on PATH,
    else /usr/local/cuda/bin/nvcc; raises if there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=None) -> Dict[str, float]:
    """Compile the kernels not built yet, one `nvcc` per source, all in
    parallel. Returns {name: seconds} of the compiles it ran; the
    compiler's report (registers, spills) lands in BUILD_LOG."""
    import time

    names = list(SIGNATURES) if names is None else list(names)
    todo = {n: _lib_path(n) for n in names if not _lib_path(n).exists()}
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    secs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return secs


def _load(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            fn = getattr(lib, name)
            fn.argtypes = list(SIGNATURES[name])
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel `name` on `device`'s current stream; raise if the
    launch was refused. Tensors in `args` are passed by address."""
    lib = _load(name)
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, name)(*cargs, stream)
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg}")
    LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def check_cuda_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                      device: torch.device, shape: tuple) -> torch.Tensor:
    """`t` made contiguous, after checking that it lies on `device` with
    `dtype` and `shape`; raises otherwise."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    return t.contiguous()
