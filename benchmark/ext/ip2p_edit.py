"""InstructPix2Pix in the edit loop: the driver of traffic `edit-refresh`,
the UNet's and the VAE's work counts, and the `span_roofline` kind.

`ip2p-edit` builds `EditSystem` as the `edit` driver does, with the
guidance the program's CLI builds (`apps/launch.py::build_guidance("ip2p",
...)` with `guidance_kwargs.native`: the port's own SD-1.5 pipeline) on
weights and text states this module makes from the seed
(`ip2p_reference.seeded_state_dicts`), which the reference then loads
again. Every view's first target is a seeded image, set at set-up;
after that the targets of a step's two views are refreshed through the
pipeline every `per_editing_step` steps, synchronously.

Set-up: the first three steps (step 0 refreshes its two views), the
steps up to the first cycle's end, the densify warm-up. The window
starts at a step that is a multiple of the cycle and stops only after a
step that ends a cycle, past the deadline: it holds whole cycles, each
one refresh event of two views and the plain steps after it. Without a
window (`--check-seeds`) the first cycle's refresh step runs alone.

What decides `correct`:
  * the training checks of the `edit` driver over the first three
    steps, the reference trained on the targets the program trained on;
  * `densify_alive_diff`, as edit1m's (optional);
  * `unet_gap`: the relative L2 gap of the program's first UNet output
    in the window (or of the refresh step run alone) against the
    float32 reference (TF32 off) on the same inputs;
  * `refresh_latent_gap` and `refresh_off_share`: that refresh's final
    latents and edited image against the reference pipeline run end to
    end from the same images, with the generator's state the program's
    had before it (so the same t and draws): the latents' relative L2
    gap, and the share of image values more than 2 levels of 255 apart.
    The image's relative L2 gap is an `info` line (`refresh_image_gap`):
    neither control reads far enough above its sound readings for it to
    hold a limit, and the two checks above already fail both.
`--control 1` runs the program with its UNet in bfloat16 (`CONTROL`,
"bf16"); `CONTROL = "drop_step"` instead skips the middle DDIM update of
every refresh. Both must come out not correct.

`KERNELS["unet"]` is one UNet evaluation at the 3-way guidance's batch of
3 and `KERNELS["vae"]` one refresh's two encodes and one decode, for a
view of the run's `work`, at the H100's dense fp16 tensor-core peak:
their multiply-adds counted from the published shapes here, not from the
program (`tests/test_torch_port_sd15.py` holds the counts to
`torch.utils.flop_counter`). The driver reads from the schedule how many
of each the window ran (`info` `unet_evals_scheduled`,
`refreshes_scheduled`) and sets `extra_least_s` to their least time a
step.
"""

from __future__ import annotations

import statistics
import time
import types
from typing import Dict, List

import numpy as np
import torch

from benchmark import counts
from benchmark import reference as R
from benchmark import scene as S
from benchmark import workload as W
from benchmark.ext import ip2p_reference as ref

# NVIDIA H100 SXM data sheet: dense FP16 on the tensor cores
PEAK_FP16 = 989.4e12
CFG_BATCH = 3         # the text, image and unconditional rows
WEIGHTS_STREAM, DRAWS_STREAM = 2000, 2001
CONTROL = "bf16"      # what `--control 1` runs: "bf16" or "drop_step"
LEVELS = 255.0        # the off share counts values more than 2 of these


# --- work counts: FLOPs, a multiply-add as two ---

def _conv(cin: int, cout: int, k: int, pixels: int) -> float:
    return 2.0 * cin * cout * k * k * pixels


def _lin(cin: int, cout: int, tokens: int) -> float:
    return 2.0 * cin * cout * tokens


def _attn(nq: int, nk: int, dim: int) -> float:
    """q k^T and the weights times v, over all heads."""
    return 2.0 * 2.0 * nq * nk * dim


def _resnet(cin: int, cout: int, px: int, temb: int = 0) -> float:
    f = _conv(cin, cout, 3, px) + _conv(cout, cout, 3, px)
    f += _lin(temb, cout, 1) if temb else 0.0
    return f + (_conv(cin, cout, 1, px) if cin != cout else 0.0)


def _transformer(c: int, px: int, text: int, ctx: int) -> float:
    return (2 * _conv(c, c, 1, px)
            + 4 * _lin(c, c, px) + _attn(px, px, c)       # self
            + 2 * _lin(c, c, px) + 2 * _lin(ctx, c, text)  # cross
            + _attn(px, text, c)
            + _lin(c, 8 * c, px) + _lin(4 * c, c, px))    # GEGLU


def unet_flops(h: int, w: int, batch: int = CFG_BATCH,
               cfg: dict = ref.UNET, text: int = ref.TEXT_LEN) -> float:
    """One UNet evaluation of `batch` latents of h x w."""
    ch = list(cfg["block_out_channels"])
    temb, ctx, n = 4 * ch[0], cfg["cross_attention_dim"], \
        cfg["layers_per_block"]
    levels = len(ch)
    px = h * w
    f = _conv(cfg["in_channels"], ch[0], 3, px)
    f += _lin(ch[0], temb, 1) + _lin(temb, temb, 1)
    cin = ch[0]
    for i, c in enumerate(ch):
        for j in range(n):
            f += _resnet(cin if j == 0 else c, c, px, temb)
            if i < levels - 1:
                f += _transformer(c, px, text, ctx)
        if i < levels - 1:
            px //= 4
            f += _conv(c, c, 3, px)
        cin = c
    f += 2 * _resnet(ch[-1], ch[-1], px, temb)
    f += _transformer(ch[-1], px, text, ctx)
    for i, res in enumerate(ref.up_channels(cfg)):
        for a, b in res:
            f += _resnet(a, b, px, temb)
            if i > 0:
                f += _transformer(b, px, text, ctx)
        if i < levels - 1:
            px *= 4
            f += _conv(res[-1][1], res[-1][1], 3, px)
    f += _conv(ch[0], cfg["out_channels"], 3, px)
    return batch * f


def _vae_mid(c: int, px: int) -> float:
    return 2 * _resnet(c, c, px) + 4 * _lin(c, c, px) + _attn(px, px, c)


def vae_flops(height: int, width: int, cfg: dict = ref.VAE) -> tuple:
    """(one encode of a height x width image, one decode to it)."""
    ch = list(cfg["block_out_channels"])
    lat, n = cfg["latent_channels"], cfg["layers_per_block"]
    px = height * width
    enc = _conv(cfg["in_channels"], ch[0], 3, px)
    cin = ch[0]
    for i, c in enumerate(ch):
        for j in range(n):
            enc += _resnet(cin if j == 0 else c, c, px)
        if i < len(ch) - 1:
            px //= 4
            enc += _conv(c, c, 3, px)
        cin = c
    enc += _vae_mid(ch[-1], px) + _conv(ch[-1], 2 * lat, 3, px) \
        + _conv(2 * lat, 2 * lat, 1, px)
    dec = _conv(lat, lat, 1, px) + _conv(lat, ch[-1], 3, px) \
        + _vae_mid(ch[-1], px)
    rev = ch[::-1]
    cin = rev[0]
    for i, c in enumerate(rev):
        for j in range(n + 1):
            dec += _resnet(cin if j == 0 else c, c, px)
        if i < len(rev) - 1:
            px *= 4
            dec += _conv(c, c, 3, px)
        cin = c
    dec += _conv(ch[0], cfg["out_channels"], 3, px)
    return enc, dec


def latent_factor(cfg: dict = ref.VAE) -> int:
    return 2 ** (len(cfg["block_out_channels"]) - 1)


def unet_least_s(w: dict) -> float:
    f = latent_factor()
    return unet_flops(w["height"] // f, w["width"] // f) / PEAK_FP16


def vae_least_s(w: dict) -> float:
    enc, dec = vae_flops(w["height"], w["width"])
    return (2 * enc + dec) / PEAK_FP16


def span_roofline(run, m):
    """The least time of the work a span ran over the device time under
    it: `count`'s least time for a view of the run's work, times the
    `info` entry `times` (how many the window ran)."""
    if run.spans is None or not run.work:
        return None
    times = run.info.get(m["times"])
    spent = 1e-3 * run.spans.device_ms(m["span"])
    if not times or spent <= 0:
        return None
    kernel = counts.kernel(m["count"])
    return 100.0 * times * sum(map(kernel, run.work)) / len(run.work) / spent


# --- the driver ---

def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


class _Capture:
    """The first refresh after `arm()`: the guidance's inputs, the
    generator's state before it, its first UNet call's inputs and output,
    the latents it decodes and the image it returns."""

    def __init__(self, system, pipe):
        self.data: dict = {}
        self.armed = False
        self.pipe = pipe
        guidance = system.guidance

        def hooked(rgb, cond_rgb, prompt):
            if not self.armed or self.data:
                return guidance(rgb, cond_rgb, prompt)
            self.data.update(rgb=np.array(rgb), cond=np.array(cond_rgb),
                             state=pipe.generator.get_state())
            handle = pipe.unet.register_forward_hook(self._unet,
                                                     with_kwargs=True)
            decode = pipe.vae.decode
            pipe.vae.decode = lambda z: (self.data.setdefault(
                "z", z.detach().float().clone()), decode(z))[1]
            try:
                out = guidance(rgb, cond_rgb, prompt)
            finally:
                handle.remove()
                del pipe.vae.decode
            self.data["image"] = np.array(out.edit_image)
            return out

        system.guidance = hooked

    def _unet(self, module, args, kwargs, out):
        if "unet_out" not in self.data:
            self.data.update(
                unet_in=args[0].detach().clone(), unet_t=int(args[1]),
                unet_ctx=kwargs["encoder_hidden_states"].detach().clone(),
                unet_out=out.sample.detach().clone())


def _drop_middle_step(sched) -> None:
    """The control: every refresh skips its middle DDIM update."""
    step = sched.step

    def dropped(model_output, timestep, sample):
        if int(timestep) == int(sched.timesteps[len(sched.timesteps) // 2]):
            return types.SimpleNamespace(prev_sample=sample)
        return step(model_output, timestep, sample)

    sched.step = dropped


def model_weights(cfg: dict, seed: int, device) -> tuple:
    g = cfg["guidance"]
    return ref.seeded_state_dicts(seed * 1_000_003 + WEIGHTS_STREAM, device,
                                  g["unet"], g["vae"])


def build(cfg: dict, seed: int, device, control):
    """The guidance as the program's CLI builds it, on this seed's
    weights; the UNet in bfloat16 for the bf16 control."""
    from gaussianeditor_tpu_torch.apps.launch import build_guidance

    g = cfg["guidance"]
    unet_sd, vae_sd, text = model_weights(cfg, seed, device)
    native = dict(state_dicts=(unet_sd, vae_sd, text),
                  unet_dtype="bfloat16" if control == "bf16"
                  else g["unet_dtype"],
                  vae_dtype=g["vae_dtype"],
                  generator_seed=(seed * 1_000_003 + DRAWS_STREAM)
                  % (1 << 62),
                  unet_config=g["unet"], vae_config=g["vae"],
                  scheduler_config=g["scheduler"])
    del unet_sd, vae_sd, text
    out = build_guidance(g["name"], {"device": str(device), "guidance_kwargs": {
        "native": native, "diffusion_steps": g["diffusion_steps"],
        "guidance_scale": g["guidance_scale"],
        "image_guidance_scale": g["image_guidance_scale"],
        "min_step_percent": g["min_step_percent"],
        "max_step_percent": g["max_step_percent"]}})
    native.clear()
    return out


def ip2p_edit(cell: W.Cell) -> W.Run:
    try:
        from gaussianeditor_tpu_torch.guidance import sd15  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"benchmark: the program has no native "
                         f"InstructPix2Pix pipeline: {e}")
    from gaussianeditor_tpu_torch.edit.edit_system import (
        EditConfig,
        EditSystem,
    )
    from gaussianeditor_tpu_torch.train.lpips import lpips
    from gaussianeditor_tpu_torch.train.trainer import LossWeights

    cfg, dev, seed = cell.cfg, cell.device, cell.seed
    t = cfg["train"]
    cycle = int(t["per_editing_step"])
    control = CONTROL if cell.control else None
    run = W.Run(views_per_step=int(t["batch_size"]), perceptual="lpips",
                anchors=True)
    guidance = build(cfg, seed, dev, control)
    pipe = guidance.pipe
    if control == "drop_step":
        _drop_middle_step(pipe.scheduler)
    scene = W.program_scene(cfg, S.scene_params(cfg["scene"], seed, dev))
    cams = W.program_cameras(S.camera_poses(cfg["cameras"]), dev)
    frames = W.targets(cfg, seed, dev).cpu().numpy()
    weights = S.lpips_weights(seed, dev)
    system = EditSystem(
        scene, cams,
        EditConfig(**t, prompt=cfg["guidance"]["prompt"],
                   loss=LossWeights(**cfg["loss"]),
                   anchor_weight_init_g0=cfg["anchor_weight_init_g0"],
                   seed=W.program_seed(seed)),
        guidance=guidance, perceptual=lambda p, tg: lpips(weights, p, tg))
    del scene, guidance
    system.on_fit_start()
    for v in range(len(frames)):
        system.edit_frames[v] = frames[v]
    del frames
    # the first steps' views and the targets they trained on
    picks: List[List[int]] = []
    step_targets: List[torch.Tensor] = []
    sample, train_step = system.sampler.sample, system.train_step
    system.sampler.sample = lambda bs=None: picks.append(sample(bs)) or \
        picks[-1]

    def recording_step(state, cams, targets, *rest):
        step_targets.append(targets.clone())
        return train_step(state, cams, targets, *rest)

    system.train_step = recording_step
    rd = W.Readings({k: getattr(system.state.scene, k).detach().clone()
                     for k in R.PARAMS})
    system.fit(n_steps=W.WARM_STEPS,
               callback=lambda s, m: rd.record(system.state, m))
    del system.sampler.sample
    system.train_step = train_step
    prog = rd.values()
    system.fit(n_steps=cycle - W.WARM_STEPS)
    W.warm_densify(system.state.scene, cfg, seed, dev)
    cap = _Capture(system, pipe)
    W.sync(dev)
    run.setup_s = time.perf_counter() - cell.t_start
    start = int(system.state.step)
    snap: Dict[str, dict] = {}
    cap.armed = True
    if cell.window:
        dens = system.densify_step

        def densify_step(state, generator=None, noise=None):
            # the first densify event: the state before and after it
            if snap:
                return dens(state, generator=generator, noise=noise)
            snap["before"] = W._densify_state(state)
            out = dens(state, generator=generator, noise=noise)
            snap["after"] = W._densify_state(state)
            snap["noise"] = noise
            return out

        system.densify_step = densify_step
        slots = int(cfg["scene"]["capacity"])

        def body(deadline):
            n = [0]
            system.fit(n_steps=W.MAX_STEPS,
                       callback=lambda s, m: n.__setitem__(0, n[0] + 1),
                       should_stop=lambda: (n[0] % cycle == 0 and
                                            time.perf_counter() >= deadline),
                       densify_noise=lambda s: W.split_noise(slots, seed, s,
                                                             dev))
            return n[0]

        W.timed(cell, run, body)
    else:
        system.fit(n_steps=1)
    steps = range(start, int(system.state.step))
    refreshes = run.views_per_step * sum(
        1 for s in steps if s % cycle == 0
        and t["edit_begin_step"] <= s < t["edit_until_step"])
    run.memory_peak = W.peak_memory(cell)
    data = cap.data
    del system, weights, pipe, cap
    W.free_program()
    training_checks(prog, cell, picks, step_targets, run)
    if snap:
        W.densify_checks(snap, cfg, run)
    refresh_checks(data, cell, run)
    if cell.window and run.steps:
        ddim = int(cfg["guidance"]["diffusion_steps"])
        run.info["refreshes_scheduled"] = refreshes
        run.info["unet_evals_scheduled"] = refreshes * ddim
        per_refresh = sum(ddim * unet_least_s(w) + vae_least_s(w)
                          for w in run.work) / len(run.work)
        run.extra_least_s = refreshes * per_refresh / run.steps
    return run


def training_checks(prog: tuple, cell: W.Cell, picks: List[List[int]],
                    targets: List[torch.Tensor], run: W.Run) -> None:
    """`workload.training_checks`, the reference trained on the targets
    the program trained on (step 0's come from the pipeline)."""
    t0 = time.perf_counter()
    cfg, dev, seed = cell.cfg, cell.device, cell.seed
    sc = cfg["scene"]
    n = int(sc["n_gaussians"])
    poses = S.camera_poses(cfg["cameras"])
    params = S.scene_params(sc, seed, dev)
    p0 = {k: v[:n].clone() for k, v in params.items()}
    tr = R.Trainer(params, n, int(sc["sh_degree"]), W.reference_train(cfg),
                   lpips_w=S.lpips_weights(seed, dev))
    del params
    losses = [tr.step(s, [R.camera(poses[v], dev) for v in picks[s]],
                      targets[s]) for s in range(W.WARM_STEPS)]
    run.work = tr.work
    grad = {k: float(torch.linalg.vector_norm(g, dtype=torch.float64))
            for k, g in tr.first_grad.items()}
    change = {k: float(torch.linalg.vector_norm(tr.p[k] - p0[k],
                                                dtype=torch.float64))
              for k in p0}
    med = statistics.median(grad.values())
    keep = {k for k, v in grad.items() if v >= 1e-3 * med}
    run.checks["loss_gap"] = max(abs(a - b) / abs(b)
                                 for a, b in zip(prog[0], losses))
    run.checks["grad_gap"] = W.norm_gap(prog[1], grad)
    run.checks["step_gap"] = W.norm_gap(prog[2], change, keep)
    run.check_s += time.perf_counter() - t0


def refresh_checks(data: dict, cell: W.Cell, run: W.Run) -> None:
    """The first UNet call and the whole refresh against the float32
    reference (the module docstring)."""
    t0 = time.perf_counter()
    cfg, dev = cell.cfg, cell.device
    g = cfg["guidance"]
    ucfg, vcfg = g["unet"], g["vae"]
    unet_sd, vae_sd, text = model_weights(cfg, cell.seed, dev)
    with ref.exact(), torch.no_grad():
        x = data["unet_in"].float()
        want = ref.unet(unet_sd, x, torch.full((x.shape[0],), data["unet_t"],
                                               device=dev),
                        data["unet_ctx"].float(), ucfg)
        run.checks["unet_gap"] = _rel(data["unet_out"], want)
        del want, x
        gen = torch.Generator(device=dev)
        gen.set_state(data["state"])
        r = ref.refresh(unet_sd, vae_sd, data["rgb"], data["cond"], text, gen,
                        steps=g["diffusion_steps"],
                        guidance_scale=g["guidance_scale"],
                        image_guidance_scale=g["image_guidance_scale"],
                        min_step_percent=g["min_step_percent"],
                        max_step_percent=g["max_step_percent"],
                        unet_cfg=ucfg, vae_cfg=vcfg, sched=g["scheduler"])
    image = torch.as_tensor(data["image"], device=dev)
    run.checks["refresh_latent_gap"] = _rel(
        data["z"], r["latents"] / vcfg["scaling_factor"])
    run.info["refresh_image_gap"] = _rel(image, r["image"])
    run.checks["refresh_off_share"] = float(
        ((image - r["image"]).abs() * LEVELS > 2.0).float().mean())
    run.info["refresh_t"] = r["t"]
    run.info["unet_out_std"] = float(data["unet_out"].float().std())
    run.info["refresh_latent_std"] = float(r["latents"].std())
    run.check_s += time.perf_counter() - t0


DRIVERS = {"ip2p-edit": ip2p_edit}
KINDS = {"span_roofline": span_roofline}
KERNELS = {"unet": unet_least_s, "vae": vae_least_s}
