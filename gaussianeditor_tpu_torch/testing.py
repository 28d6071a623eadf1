"""Comparison helpers and test inputs shared by the port's tests and
`chip_smoke.py`.

`assert_images_close` is a copy of `tests/helpers.py::assert_images_close`
(the JAX suite's image tolerance), kept here so that code which must not
import the JAX test helpers can apply the same bounds. `adversarial_rows`
and `dense_from_rows` make inputs for the backward kernels' tests, on the
CPU and on the card, and `key_layouts` for kernel B1's;
`kernel_constants` reads a kernel source's constants. `tie_scene` and
`tie_camera` build the preprocess's slots on each tie of its backward,
for the plain version on the CPU and the kernels on the card.
`watch_served_fit`, `whole_step_frames` and `whole_step_index` check
that the web UI serves only whole steps of a fit. `run_ranks` runs a
function on spawned ranks of one process group (gloo on the CPU in the
tests; two ranks sharing one card in
`chip_smoke.py`), and `fingerprint` compares tensors across ranks
without shipping them.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def assert_images_close(a, b, tight=3e-5, loose=6e-3, frac=0.995,
                        name="image"):
    """Two numerically equivalent rasterizers can flip the alpha-cutoff
    test (alpha < 1/255) on borderline Gaussians through a different
    rounding order; each flip moves a pixel by up to ~alpha_min * color
    ~ 4e-3. So the vast majority of pixels must match tightly and all
    pixels within the cutoff-flip bound."""
    a, b = _host(a), _host(b)
    diff = np.abs(a - b)
    assert diff.max() <= loose, f"{name}: max diff {diff.max()} > {loose}"
    ok = np.mean(diff <= tight)
    assert ok >= frac, f"{name}: only {ok:.4f} of pixels within {tight}"


def fraction_equal(a, b) -> float:
    """Share of entries where `a` and `b` are equal."""
    return float(np.mean(_host(a) == _host(b)))


def adversarial_rows(seed, ch, gx=4, gy=3, device="cpu"):
    """Depth-sorted rows made directly, tile by tile, for the backward
    kernels: centres inside the tile, near it and hundreds of pixels
    outside; radii from half a pixel to 400; opacities at the 0.99 cap,
    just above 1/255, and between; 20 to 299 rows a tile. Returns (start,
    cnt, payload [7 + ch, n], grid_x)."""
    rng = np.random.RandomState(seed)
    T = gx * gy
    cnt = rng.randint(20, 300, size=T)
    cols = []
    for t in range(T):
        k = cnt[t]
        cx = (t % gx) * 16 + 8.0
        cy = (t // gx) * 16 + 8.0
        kind = rng.randint(0, 3, size=k)
        reach = np.choose(kind, [8.0, 60.0, 400.0])
        off = rng.uniform(-1, 1, (k, 2)) * reach[:, None]
        sig = np.exp(rng.uniform(np.log(0.5), np.log(400.0), (k, 2)))
        th = rng.uniform(0, np.pi, k)
        cos, sin = np.cos(th), np.sin(th)
        # conic = (R diag(sig^2) R^T)^-1
        i1, i2 = 1 / sig[:, 0] ** 2, 1 / sig[:, 1] ** 2
        a = cos * cos * i1 + sin * sin * i2
        b = cos * sin * (i1 - i2)
        c = sin * sin * i1 + cos * cos * i2
        opk = rng.randint(0, 3, size=k)
        op = np.choose(opk, [rng.uniform(0.991, 1.0, k),
                             (1 / 255) * rng.uniform(1.0, 1.05, k),
                             rng.uniform(0.05, 0.95, k)])
        depth = np.sort(rng.uniform(1, 10, k))
        color = rng.uniform(0, 1, (ch, k))
        cols.append(np.concatenate(
            [np.stack([cx + off[:, 0], cy + off[:, 1], a, b, c, op, depth]),
             color]).astype(np.float32))
    payload = torch.from_numpy(np.concatenate(cols, axis=1)).to(device)
    start = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    return (torch.from_numpy(start).to(device),
            torch.from_numpy(cnt).to(device), payload, gx)


def kernel_constants(source: str) -> dict:
    """The namespace-scope `constexpr int` constants of `csrc/<source>`,
    each expression evaluated over the constants before it (so a
    constant defined from others, such as B1's kRanks, is its value)."""
    from gaussianeditor_tpu_torch.ops._kernels import CSRC_DIR

    out = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                 (CSRC_DIR / source).read_text(), re.M):
        out[name] = int(eval(expr, {}, dict(out)))
    return out


def key_layouts(device="cpu") -> list:
    """Inputs of kernel B1 built to break a windowed owner search, each
    (name, proc, grid_x, grid_y, n, total, depth_bits): a run of dead slots
    (tiles_touched 0) longer than a block's window; one Gaussian whose
    ranks span several blocks; n below total, above it (ranks past
    b_incl[C - 1] belong to the last slot, here a dead one), and not a
    multiple of 4; grids whose live keys set bit 31 (16 x 12 tiles at 24
    depth bits, 82 x 53 at 19); a single slot; 1, 2 and 3 channels. The
    fields B1 does not read are empty."""
    from gaussianeditor_tpu_torch.ops.preprocess import ProcessedGaussians

    def layout(seed, gx, gy, wh, ch):
        """Slots with rects of the given (w, h) (0 for a dead slot) at
        random places inside the grid."""
        rng = np.random.RandomState(seed)
        C = len(wh)
        w = np.array([a for a, _ in wh], np.int32)
        h = np.array([b for _, b in wh], np.int32)
        rx = (rng.rand(C) * (gx - w + 1)).astype(np.int32)
        ry = (rng.rand(C) * (gy - h + 1)).astype(np.int32)
        f32 = np.float32
        t = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
        return ProcessedGaussians(
            mean2d=t(rng.uniform(-50, 900, (C, 2)).astype(f32)),
            depth=t(rng.uniform(0.2, 100.0, C).astype(f32)),
            conic=t(rng.uniform(-1, 1, (C, 3)).astype(f32)),
            color=t(rng.rand(C, ch).astype(f32)),
            opacity=t(rng.rand(C).astype(f32)),
            radius=t(np.zeros(0, np.int32)),
            visible=t(np.zeros(0, bool)),
            rect_min=t(np.stack([rx, ry], 1)),
            rect_max=t(np.stack([rx + w, ry + h], 1)),
            tiles_touched=t(w * h))

    def small(rng, k, dead=0.0, top=3):
        return [(0, 0) if rng.rand() < dead else
                (rng.randint(1, top + 1), rng.randint(1, top + 1))
                for _ in range(k)]

    def total_of(proc):
        return int(proc.tiles_touched.sum())

    rng = np.random.RandomState(7)
    out = []
    # 3,000 small slots, 5,000 dead ones, 4,000 small ones
    wh = small(rng, 3000) + [(0, 0)] * 5000 + small(rng, 4000)
    p = layout(1, 32, 32, wh, 3)
    out.append(("dead run", p, 32, 32, total_of(p), total_of(p), 21))
    # one 60 x 50 rect among small slots, half of them dead: 3,000 ranks
    wh = small(rng, 900, dead=0.5) + [(60, 50)] + small(rng, 1100, dead=0.5)
    p = layout(2, 82, 53, wh, 2)
    out.append(("long Gaussian, n < total", p, 82, 53, total_of(p) - 1027,
                total_of(p), 19))
    # live slots, then three quarters of the slots dead capacity; n past
    # total
    wh = small(rng, 750, dead=0.3, top=4) + [(0, 0)] * 2250
    p = layout(3, 16, 12, wh, 3)
    out.append(("dead tail, n > total", p, 16, 12, total_of(p) + 37,
                total_of(p), 24))
    # n half of total, not a multiple of 4
    wh = small(rng, 5000, dead=0.75, top=5)
    p = layout(4, 82, 53, wh, 1)
    out.append(("n half of total", p, 82, 53, total_of(p) // 2 | 1,
                total_of(p), 19))
    # a single slot of 7 tiles
    p = layout(5, 9, 1, [(7, 1)], 1)
    out.append(("one slot", p, 9, 1, 10, 7, 27))
    return out


def dense_from_rows(start, cnt, payload):
    """The chunk-aligned layout of `adversarial_rows`' tiles: (inst [NC,
    7 + ch, 128], a DenseBinning whose chunk fields describe it; the
    fields the backward does not read are empty)."""
    from gaussianeditor_tpu_torch.ops.binning_dense import CHUNK, DenseBinning

    dev = payload.device
    P = payload.shape[0]
    tiles, offs, nvalid, src = [], [], [], []
    for t, (s0, c) in enumerate(zip(start.tolist(), cnt.tolist())):
        for off in range(0, c, CHUNK):
            tiles.append(t)
            offs.append(off)
            nvalid.append(min(CHUNK, c - off))
            src.append(s0 + off)
    tiles.append(0)          # one dead chunk past the last tile
    offs.append(0)
    nvalid.append(0)
    src.append(0)
    NC = len(tiles)
    inst = torch.zeros((NC, P, CHUNK), device=dev)
    for k in range(NC - 1):
        inst[k, :, :nvalid[k]] = payload[:, src[k]:src[k] + nvalid[k]]
    i32 = dict(dtype=torch.int32, device=dev)
    empty = torch.zeros((0,), dtype=torch.int64, device=dev)
    db = DenseBinning(
        sorted_g=empty, a_by_rank=empty, b_incl=empty.to(torch.int32),
        chunk_p0=torch.tensor(src, dtype=torch.int64, device=dev),
        chunk_tile=torch.tensor(tiles, **i32),
        chunk_first=torch.tensor([int(o == 0) for o in offs], **i32),
        chunk_nvalid=torch.tensor(nvalid, **i32),
        chunk_offset=torch.tensor(offs, **i32),
        tile_nonempty=cnt > 0,
        num_rendered=torch.tensor(int(cnt.sum()), **i32),
        overflow=torch.tensor(False, device=dev))
    return inst, db


def scene_storage(scene) -> set:
    """The storage addresses of a GaussianScene's non-empty parameters and
    buffers."""
    return {t.untyped_storage().data_ptr()
            for t in list(scene.parameters()) + list(scene.buffers())
            if t.numel() > 0}


def watch_served_fit(state, pose, size: int, steps: int, prompt: str = "p",
                     timeout: float = 600.0):
    """Start an edit fit of `steps` steps on the web UI's `state` and,
    while it runs, take frames of the client pose `pose` (16 floats, fov
    0.8) through `state.render_image`, each time checking under the lock
    that the served scene shares no storage with the training state's
    scene. Returns (frames, shared): the float frames taken while the fit
    ran and the number of checks that found shared storage. Raises if
    the fit does not end within `timeout` seconds."""
    import time

    out = state.start_training(prompt, steps, "edit")
    assert out.get("started"), out
    frames, shared = [], 0
    t_end = time.monotonic() + timeout
    try:
        while state.training and time.monotonic() < t_end:
            frames.append(state.render_image(0.0, 0.0, 0.0, size, False,
                                             pose=pose))
            system = state._active_system
            with state.lock:
                if system is not None and system.state is not None:
                    shared += bool(scene_storage(state.scene)
                                   & scene_storage(system.state.scene))
    finally:
        if state.training:
            state.stop_flag = True
        assert state.join(timeout), "the served fit did not end"
    assert "error" not in state.last_metrics, state.last_metrics
    return frames, shared


def whole_step_frames(scene, cameras, cfg, pose, size: int, guidance,
                      segmentor=None):
    """What a served fit may show at `pose`: `webui.scene_image` of
    `scene`, then of the training state's scene after each whole step of
    `EditSystem(scene, cameras, cfg, ...).fit()`. Returns (frames,
    system)."""
    from gaussianeditor_tpu_torch.apps.webui import scene_image
    from gaussianeditor_tpu_torch.core.cameras import Camera
    from gaussianeditor_tpu_torch.edit.edit_system import EditSystem

    cam = Camera.from_c2w(np.asarray(pose, np.float64).reshape(4, 4), 0.8,
                          0.8, size, size, device=scene.device)
    frames = [scene_image(scene, cam, False, cfg.max_instances)]
    system = EditSystem(scene, cameras, cfg, guidance=guidance,
                        segmentor=segmentor)
    system.fit(callback=lambda step, m: frames.append(scene_image(
        system.state.scene, cam, False, cfg.max_instances)))
    return frames, system


def whole_step_index(frame: np.ndarray, candidates) -> int:
    """The index of the first candidate bitwise equal to `frame`, or -1."""
    for i, c in enumerate(candidates):
        if np.array_equal(frame, c):
            return i
    return -1


SPAWN_TIMEOUT = 600.0   # seconds for a whole spawn, start-up included


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(fn, rank, world, port, device, backend, timeout, args, q):
    import traceback
    from datetime import timedelta

    try:
        import torch.distributed as dist

        from gaussianeditor_tpu_torch.parallel.mesh import (
            initialize_distributed,
        )

        if str(device) == "cpu":
            torch.set_num_threads(1)
        initialize_distributed(f"127.0.0.1:{port}", world, rank, backend,
                               device=device,
                               timeout=timedelta(seconds=timeout))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        q.put((rank, out, None))
    except BaseException:
        q.put((rank, None, traceback.format_exc()))


def run_ranks(fn, world: int, *args, device="cpu", backend=None,
              timeout: float = SPAWN_TIMEOUT) -> list:
    """[fn(0, world, *args), ..., fn(world - 1, world, *args)], each call
    in its own spawned process, joined into one process group on a free
    localhost port by `parallel.mesh.initialize_distributed(device=device,
    backend=backend)` (on the CPU, one torch thread a rank). `fn` must be
    importable by a fresh interpreter, and its results picklable. A rank
    that raises ends the others at once, and every rank still running at
    `timeout` seconds is killed: the call then raises, so a hung
    collective fails instead of hanging its caller."""
    import multiprocessing as mp
    import queue
    import time

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world, port, device, backend, timeout,
                               args, q), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    results, error = {}, None
    try:
        while len(results) < world and error is None:
            try:
                rank, out, err = q.get(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                missing = sorted(set(range(world)) - set(results))
                error = f"ranks {missing} did not finish within {timeout} s"
                break
            if err is not None:
                error = f"rank {rank} failed:\n{err}"
            else:
                results[rank] = out
    finally:
        for p in procs:
            if error is not None:
                p.kill()
            p.join(timeout=max(deadline - time.monotonic(), 5.0))
            if p.is_alive():
                p.kill()
                p.join()
    if error is not None:
        raise RuntimeError(error)
    return [results[r] for r in range(world)]


def fingerprint(tensors) -> torch.Tensor:
    """Exact int64 sums of each 1024-element block of each float32
    tensor's bit patterns, weighted by position in the block: equal
    tensors give equal fingerprints, and any one changed element changes
    its block's sum (|bits| < 2^31 and weights <= 1024, so a block's sum
    stays below 2^52)."""
    out = []
    for t in tensors:
        b = t.detach().reshape(-1).view(torch.int32).to(torch.int64)
        b = torch.cat([b, b.new_zeros((-b.numel()) % 1024)]).view(-1, 1024)
        w = torch.arange(1, 1025, dtype=torch.int64, device=b.device)
        out.append((b * w).sum(dim=1))
    return torch.cat(out)



# the slots of `tie_scene` built on a tie, and its image size
TIE_X, TIE_Y, TIE_COLOR, TIE_QUAT = 0, 1, 2, 3
TIE_SLOTS = 96
TIE_W, TIE_H = 56, 40


def tie_camera(device="cpu"):
    """A camera at the origin looking down +z with world_view = I, so that
    a slot's camera coordinates are its own and a tie can be built
    exactly."""
    from gaussianeditor_tpu_torch.core.cameras import (
        Camera,
        get_projection_matrix,
    )

    fovx, fovy = 0.9, 0.7
    proj = get_projection_matrix(0.01, 100.0, fovx, fovy)
    f32 = dict(dtype=torch.float32, device=device)
    return Camera(world_view=torch.eye(4, **f32),
                  full_proj=torch.as_tensor(proj, device=device),
                  cam_pos=torch.zeros(3, **f32),
                  tan_fovx=torch.tensor(math.tan(fovx / 2), **f32),
                  tan_fovy=torch.tensor(math.tan(fovy / 2), **f32),
                  height=TIE_H, width=TIE_W)


def _nearest(start: float, dtype, hit) -> float:
    """The value of `dtype` nearest `start` (within 256 steps of its
    spacing) for which `hit(value tensor)` holds."""
    v = torch.tensor(start, dtype=dtype)
    up = torch.tensor(math.inf, dtype=dtype)
    down = -up
    lo = hi = v
    for _ in range(256):
        for c in (lo, hi):
            if bool(hit(c)):
                return float(c)
        lo, hi = torch.nextafter(lo, down), torch.nextafter(hi, up)
    raise ValueError(f"no {dtype} value near {start} makes the tie")


def tie_scene(max_sh_degree: int, dtype, device="cpu", seed: int = 0):
    """(xyz, log_scales, quats, opacity, features_dc, features_rest,
    alive) of TIE_SLOTS slots in front of `tie_camera`, with near-culled,
    frustum-clamped, dead-opacity, zero-quaternion and dead slots, and one
    slot on each tie of the preprocess's backward, exact in `dtype` under
    the plain version's arithmetic: t/tz at +lim in x (TIE_X) and -lim
    in y (TIE_Y), colour channel 1 at SH + 0.5 == 0 (TIE_COLOR), |q|^2
    at clamp_min's 1e-24 (TIE_QUAT)."""
    from gaussianeditor_tpu_torch.core.sh import C0

    rng = np.random.RandomState(seed)
    cam = tie_camera()
    n, K = TIE_SLOTS, (max_sh_degree + 1) ** 2
    xyz = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.6, 0.6, n),
                    rng.uniform(1.0, 3.0, n)], -1)
    xyz[8:14, 2] = rng.uniform(-1.0, 0.2, 6)            # near-culled
    xyz[14:20, 0] = rng.choice([-1, 1], 6) * 4.0         # frustum-clamped
    # the clamp's limits as the plain version computes them (float32)
    limx = float(1.3 * cam.tan_fovx)
    limy = float(1.3 * cam.tan_fovy)
    xyz[TIE_X] = (2.0 * limx, 0.1, 2.0)
    xyz[TIE_Y] = (0.1, -2.0 * limy, 2.0)
    log_scales = np.log(rng.uniform(0.02, 0.2, (n, 3)))
    quats = rng.randn(n, 4)
    quats[20:24] = 0.0                                   # below clamp_min
    # two components, so that the rotation is not the identity's, whose
    # radial derivative is zero
    floor = torch.tensor(1e-24, dtype=dtype)
    qi = torch.tensor(8e-13, dtype=dtype)
    quats[TIE_QUAT] = (_nearest(6e-13, dtype,
                                lambda q: q * q + qi * qi == floor),
                       float(qi), 0.0, 0.0)
    opacity = rng.uniform(0.05, 1.0, n)
    opacity[24:30] = 1 / 300                             # dead opacity
    dc = rng.randn(n, 1, 3) * 0.5
    rest = rng.randn(n, K - 1, 3) * 0.2
    dc[TIE_COLOR, 0, 1] = _nearest(-0.5 / C0, dtype,
                                   lambda d: C0 * d + 0.5 == 0)
    rest[TIE_COLOR] = 0.0
    alive = np.ones(n, bool)
    alive[-8:] = False                                   # dead slots

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    return (t(xyz), t(log_scales), t(quats), t(opacity), t(dc), t(rest),
            torch.from_numpy(alive).to(device))
