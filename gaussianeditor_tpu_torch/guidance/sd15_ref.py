"""The plain reference of InstructPix2Pix's edit: the SD-1.5 UNet with 8
input channels, the KL VAE and 20-step DDIM with 3-way classifier-free
guidance, as functions of a state dict, in plain PyTorch.

It imports torch and numpy only: nothing of the program, so it can check
`guidance/sd15.py` and the adapter that drives it, and it is copied
whole into the benchmark (`benchmark/ext/ip2p_reference.py`; a test
holds the two files equal). Everything is computed in the dtype of the
state dict it is given, float32 with TF32 off in the checks
(`exact()`), attention as an explicit softmax over blocks of queries.

The equations are those of diffusers' `UNet2DConditionModel`,
`AutoencoderKL` and `DDIMScheduler` at the configurations of
`timbrooks/instruct-pix2pix` (`UNET`, `VAE`, `SCHEDULER`), under
diffusers' state-dict names; `refresh` is the port's adapter
(`guidance/diffusers_adapters.py::InstructPix2PixGuidance.__call__`),
whose draws it makes in the same order from the generator it is given:
t, the encoder's sample, the start noise.

`seeded_state_dicts` makes random weights at these shapes from a seed
(the published weights are not in the repository): convolutions and
linears N(0, 1/fan_in), norms at weight 1 and bias 0, biases zero, each
residual branch's last layer scaled by `BRANCH_GAIN` so that the
residual stream grows slowly through the 25 blocks, the output
convolutions by `OUT_GAIN`.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# unet/config.json, vae/config.json and the DDIM settings threestudio
# runs them with (scaled_linear betas, steps_offset 1, alpha_prod at 0
# for the last step, epsilon prediction, eta 0)
UNET = dict(in_channels=8, out_channels=4,
            block_out_channels=(320, 640, 1280, 1280), layers_per_block=2,
            cross_attention_dim=768, attention_head_dim=8,
            norm_num_groups=32, norm_eps=1e-5)
VAE = dict(in_channels=3, out_channels=3,
           block_out_channels=(128, 256, 512, 512), layers_per_block=2,
           latent_channels=4, norm_num_groups=32, scaling_factor=0.18215)
SCHEDULER = dict(num_train_timesteps=1000, beta_start=0.00085,
                 beta_end=0.012, steps_offset=1)
TEXT_LEN = 77
TRANSFORMER_GN_EPS = 1e-6
LAYER_NORM_EPS = 1e-5
VAE_EPS = 1e-6
BRANCH_GAIN = 0.5
OUT_GAIN = 1.0
QUERY_BLOCK = 1024

Shapes = Dict[str, Tuple[int, ...]]


@contextlib.contextmanager
def exact():
    """Float32 matmuls and convolutions with TF32 off."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


# --- the parameters' names and shapes ---

def _conv_shapes(out: Shapes, name: str, cin: int, cout: int, k: int,
                 bias: bool = True) -> None:
    out[f"{name}.weight"] = (cout, cin, k, k)
    if bias:
        out[f"{name}.bias"] = (cout,)


def _lin_shapes(out: Shapes, name: str, cin: int, cout: int,
                bias: bool = True) -> None:
    out[f"{name}.weight"] = (cout, cin)
    if bias:
        out[f"{name}.bias"] = (cout,)


def _norm_shapes(out: Shapes, name: str, c: int) -> None:
    out[f"{name}.weight"] = (c,)
    out[f"{name}.bias"] = (c,)


def _resnet_shapes(out: Shapes, name: str, cin: int, cout: int,
                   temb: Optional[int]) -> None:
    _norm_shapes(out, f"{name}.norm1", cin)
    _conv_shapes(out, f"{name}.conv1", cin, cout, 3)
    if temb is not None:
        _lin_shapes(out, f"{name}.time_emb_proj", temb, cout)
    _norm_shapes(out, f"{name}.norm2", cout)
    _conv_shapes(out, f"{name}.conv2", cout, cout, 3)
    if cin != cout:
        _conv_shapes(out, f"{name}.conv_shortcut", cin, cout, 1)


def _transformer_shapes(out: Shapes, name: str, c: int, ctx: int) -> None:
    _norm_shapes(out, f"{name}.norm", c)
    _conv_shapes(out, f"{name}.proj_in", c, c, 1)
    b = f"{name}.transformer_blocks.0"
    for i, kv in ((1, c), (2, ctx)):
        _norm_shapes(out, f"{b}.norm{i}", c)
        _lin_shapes(out, f"{b}.attn{i}.to_q", c, c, bias=False)
        _lin_shapes(out, f"{b}.attn{i}.to_k", kv, c, bias=False)
        _lin_shapes(out, f"{b}.attn{i}.to_v", kv, c, bias=False)
        _lin_shapes(out, f"{b}.attn{i}.to_out.0", c, c)
    _norm_shapes(out, f"{b}.norm3", c)
    _lin_shapes(out, f"{b}.ff.net.0.proj", c, 8 * c)
    _lin_shapes(out, f"{b}.ff.net.2", 4 * c, c)
    _conv_shapes(out, f"{name}.proj_out", c, c, 1)


def up_channels(cfg: dict) -> List[List[Tuple[int, int]]]:
    """Each up block's resnets' (input, output) channels, the input
    including the skip concatenated to it (diffusers' `get_up_block`)."""
    ch = list(cfg["block_out_channels"])
    rev = ch[::-1]
    n = cfg["layers_per_block"] + 1
    out, cur = [], rev[0]
    for i in range(len(rev)):
        prev, cur = cur, rev[i]
        skip_in = rev[min(i + 1, len(rev) - 1)]
        out.append([((prev if j == 0 else cur)
                     + (skip_in if j == n - 1 else cur), cur)
                    for j in range(n)])
    return out


def unet_shapes(cfg: dict = UNET) -> Shapes:
    ch = list(cfg["block_out_channels"])
    temb = 4 * ch[0]
    ctx = cfg["cross_attention_dim"]
    levels = len(ch)
    out: Shapes = {}
    _conv_shapes(out, "conv_in", cfg["in_channels"], ch[0], 3)
    _lin_shapes(out, "time_embedding.linear_1", ch[0], temb)
    _lin_shapes(out, "time_embedding.linear_2", temb, temb)
    cin = ch[0]
    for i, c in enumerate(ch):
        for j in range(cfg["layers_per_block"]):
            _resnet_shapes(out, f"down_blocks.{i}.resnets.{j}",
                           cin if j == 0 else c, c, temb)
            if i < levels - 1:
                _transformer_shapes(out, f"down_blocks.{i}.attentions.{j}",
                                    c, ctx)
        if i < levels - 1:
            _conv_shapes(out, f"down_blocks.{i}.downsamplers.0.conv", c, c, 3)
        cin = c
    for j in range(2):
        _resnet_shapes(out, f"mid_block.resnets.{j}", ch[-1], ch[-1], temb)
    _transformer_shapes(out, "mid_block.attentions.0", ch[-1], ctx)
    for i, resnets in enumerate(up_channels(cfg)):
        for j, (a, b) in enumerate(resnets):
            _resnet_shapes(out, f"up_blocks.{i}.resnets.{j}", a, b, temb)
            if i > 0:
                _transformer_shapes(out, f"up_blocks.{i}.attentions.{j}",
                                    b, ctx)
        if i < levels - 1:
            c = resnets[-1][1]
            _conv_shapes(out, f"up_blocks.{i}.upsamplers.0.conv", c, c, 3)
    _norm_shapes(out, "conv_norm_out", ch[0])
    _conv_shapes(out, "conv_out", ch[0], cfg["out_channels"], 3)
    return out


def _vae_mid_shapes(out: Shapes, name: str, c: int) -> None:
    _resnet_shapes(out, f"{name}.resnets.0", c, c, None)
    a = f"{name}.attentions.0"
    _norm_shapes(out, f"{a}.group_norm", c)
    for k in ("to_q", "to_k", "to_v", "to_out.0"):
        _lin_shapes(out, f"{a}.{k}", c, c)
    _resnet_shapes(out, f"{name}.resnets.1", c, c, None)


def vae_shapes(cfg: dict = VAE) -> Shapes:
    ch = list(cfg["block_out_channels"])
    lat = cfg["latent_channels"]
    n = cfg["layers_per_block"]
    out: Shapes = {}
    _conv_shapes(out, "encoder.conv_in", cfg["in_channels"], ch[0], 3)
    cin = ch[0]
    for i, c in enumerate(ch):
        for j in range(n):
            _resnet_shapes(out, f"encoder.down_blocks.{i}.resnets.{j}",
                           cin if j == 0 else c, c, None)
        if i < len(ch) - 1:
            _conv_shapes(out, f"encoder.down_blocks.{i}.downsamplers.0.conv",
                         c, c, 3)
        cin = c
    _vae_mid_shapes(out, "encoder.mid_block", ch[-1])
    _norm_shapes(out, "encoder.conv_norm_out", ch[-1])
    _conv_shapes(out, "encoder.conv_out", ch[-1], 2 * lat, 3)
    _conv_shapes(out, "quant_conv", 2 * lat, 2 * lat, 1)
    _conv_shapes(out, "post_quant_conv", lat, lat, 1)
    _conv_shapes(out, "decoder.conv_in", lat, ch[-1], 3)
    _vae_mid_shapes(out, "decoder.mid_block", ch[-1])
    rev = ch[::-1]
    cur = rev[0]
    for i, c in enumerate(rev):
        for j in range(n + 1):
            _resnet_shapes(out, f"decoder.up_blocks.{i}.resnets.{j}",
                           cur if j == 0 else c, c, None)
        if i < len(rev) - 1:
            _conv_shapes(out, f"decoder.up_blocks.{i}.upsamplers.0.conv",
                         c, c, 3)
        cur = c
    _norm_shapes(out, "decoder.conv_norm_out", ch[0])
    _conv_shapes(out, "decoder.conv_out", ch[0], cfg["out_channels"], 3)
    return out


def _gain(name: str) -> float:
    """The scale of a weight's N(0, 1/fan_in) draw."""
    if name.startswith(("conv_out.", "decoder.conv_out.",
                        "encoder.conv_out.")):
        return OUT_GAIN
    if name.endswith(("conv2.weight", "to_out.0.weight", "ff.net.2.weight",
                      "proj_out.weight")):
        return BRANCH_GAIN
    return 1.0


def seeded(shapes: Shapes, generator: torch.Generator,
           device) -> Dict[str, torch.Tensor]:
    """Random float32 weights at `shapes` (the module docstring's
    recipe), drawn from `generator` in the order of `shapes`."""
    out = {}
    for name, shape in shapes.items():
        if len(shape) == 1:     # a norm's weight, or a bias
            out[name] = torch.full(shape, float(name.endswith(".weight")),
                                   dtype=torch.float32, device=device)
            continue
        fan_in = int(np.prod(shape[1:]))
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        out[name] = w * (_gain(name) / math.sqrt(fan_in))
    return out


def seeded_state_dicts(seed: int, device, unet_cfg: dict = UNET,
                       vae_cfg: dict = VAE) -> tuple:
    """(UNet state dict, VAE state dict, text states [2, 77, ctx]: the
    prompt's and the empty prompt's), float32, from `seed`."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 62))
    unet = seeded(unet_shapes(unet_cfg), g, device)
    vae = seeded(vae_shapes(vae_cfg), g, device)
    text = torch.randn((2, TEXT_LEN, unet_cfg["cross_attention_dim"]),
                       generator=g, dtype=torch.float32, device=device)
    return unet, vae, text


# --- the layers ---

def _conv(p, name: str, x, stride: int = 1, padding: int = 1):
    return F.conv2d(x, p[f"{name}.weight"], p.get(f"{name}.bias"), stride,
                    padding)


def _lin(p, name: str, x):
    return F.linear(x, p[f"{name}.weight"], p.get(f"{name}.bias"))


def _gn(p, name: str, x, groups: int, eps: float):
    return F.group_norm(x, groups, p[f"{name}.weight"], p[f"{name}.bias"],
                        eps)


def attention(q, k, v, heads: int, block: int = QUERY_BLOCK):
    """softmax(q k^T / sqrt(d)) v per head, [B, N, C] in and out, the
    softmax written out over blocks of `block` queries."""
    B, N, C = q.shape
    d = C // heads
    q = q.reshape(B, N, heads, d).transpose(1, 2)
    k = k.reshape(B, -1, heads, d).transpose(1, 2)
    v = v.reshape(B, -1, heads, d).transpose(1, 2)
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(d)
    for i in range(0, N, block):
        s = torch.matmul(q[:, :, i:i + block], k.transpose(-1, -2)) * scale
        e = torch.exp(s - s.amax(-1, keepdim=True))
        out[:, :, i:i + block] = torch.matmul(e / e.sum(-1, keepdim=True), v)
    return out.transpose(1, 2).reshape(B, N, C)


def resnet(p, name: str, x, temb, groups: int, eps: float):
    h = _conv(p, f"{name}.conv1", F.silu(_gn(p, f"{name}.norm1", x, groups,
                                             eps)))
    if temb is not None:
        h = h + _lin(p, f"{name}.time_emb_proj", F.silu(temb))[:, :, None,
                                                                  None]
    h = _conv(p, f"{name}.conv2", F.silu(_gn(p, f"{name}.norm2", h, groups,
                                             eps)))
    if f"{name}.conv_shortcut.weight" in p:
        x = _conv(p, f"{name}.conv_shortcut", x, padding=0)
    return x + h


def transformer(p, name: str, x, ctx, heads: int, groups: int):
    """Transformer2DModel with one BasicTransformerBlock: self-attention,
    cross-attention over `ctx`, GEGLU feed-forward."""
    B, C, H, W = x.shape
    h = _conv(p, f"{name}.proj_in",
              _gn(p, f"{name}.norm", x, groups, TRANSFORMER_GN_EPS),
              padding=0)
    h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)
    b = f"{name}.transformer_blocks.0"

    def ln(i, t):
        return F.layer_norm(t, (C,), p[f"{b}.norm{i}.weight"],
                            p[f"{b}.norm{i}.bias"], LAYER_NORM_EPS)

    for i in (1, 2):
        y = ln(i, h)
        kv = y if i == 1 else ctx
        a = attention(_lin(p, f"{b}.attn{i}.to_q", y),
                      _lin(p, f"{b}.attn{i}.to_k", kv),
                      _lin(p, f"{b}.attn{i}.to_v", kv), heads)
        h = h + _lin(p, f"{b}.attn{i}.to_out.0", a)
    val, gate = _lin(p, f"{b}.ff.net.0.proj", ln(3, h)).chunk(2, dim=-1)
    h = h + _lin(p, f"{b}.ff.net.2", val * F.gelu(gate))
    h = h.reshape(B, H, W, C).permute(0, 3, 1, 2)
    return x + _conv(p, f"{name}.proj_out", h, padding=0)


def timestep_embedding(t, dim: int):
    """Sinusoids of `t` [B] (diffusers' `Timesteps`, flip_sin_to_cos,
    shift 0): [cos, sin] of t 10000^(-i / (dim / 2))."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    e = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(e), torch.sin(e)], dim=-1)


def unet(p, x, t, ctx, cfg: dict = UNET):
    """The noise prediction for `x` [B, in, h, w] at timesteps `t` [B]
    with text states `ctx` [B, 77, cross], in `x`'s dtype."""
    ch = list(cfg["block_out_channels"])
    g, eps, heads = cfg["norm_num_groups"], cfg["norm_eps"], \
        cfg["attention_head_dim"]
    levels = len(ch)
    temb = timestep_embedding(t, ch[0]).to(x.dtype)
    temb = _lin(p, "time_embedding.linear_2",
                F.silu(_lin(p, "time_embedding.linear_1", temb)))
    h = _conv(p, "conv_in", x)
    skips = [h]
    for i in range(levels):
        for j in range(cfg["layers_per_block"]):
            h = resnet(p, f"down_blocks.{i}.resnets.{j}", h, temb, g, eps)
            if i < levels - 1:
                h = transformer(p, f"down_blocks.{i}.attentions.{j}", h, ctx,
                                heads, g)
            skips.append(h)
        if i < levels - 1:
            h = _conv(p, f"down_blocks.{i}.downsamplers.0.conv", h, stride=2)
            skips.append(h)
    h = resnet(p, "mid_block.resnets.0", h, temb, g, eps)
    h = transformer(p, "mid_block.attentions.0", h, ctx, heads, g)
    h = resnet(p, "mid_block.resnets.1", h, temb, g, eps)
    for i in range(levels):
        for j in range(cfg["layers_per_block"] + 1):
            h = torch.cat([h, skips.pop()], dim=1)
            h = resnet(p, f"up_blocks.{i}.resnets.{j}", h, temb, g, eps)
            if i > 0:
                h = transformer(p, f"up_blocks.{i}.attentions.{j}", h, ctx,
                                heads, g)
        if i < levels - 1:
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            h = _conv(p, f"up_blocks.{i}.upsamplers.0.conv", h)
    h = F.silu(_gn(p, "conv_norm_out", h, g, eps))
    return _conv(p, "conv_out", h)


def _vae_mid(p, name: str, x, groups: int):
    x = resnet(p, f"{name}.resnets.0", x, None, groups, VAE_EPS)
    a = f"{name}.attentions.0"
    B, C, H, W = x.shape
    h = _gn(p, f"{a}.group_norm", x, groups, VAE_EPS)
    h = h.reshape(B, C, H * W).transpose(1, 2)
    h = attention(_lin(p, f"{a}.to_q", h), _lin(p, f"{a}.to_k", h),
                  _lin(p, f"{a}.to_v", h), 1)
    h = _lin(p, f"{a}.to_out.0", h).transpose(1, 2).reshape(B, C, H, W)
    return resnet(p, f"{name}.resnets.1", x + h, None, groups, VAE_EPS)


def vae_encode(p, x, cfg: dict = VAE):
    """(mean, logvar) of the latent for images `x` [B, 3, H, W] in
    [-1, 1], logvar clamped to [-30, 20]."""
    ch = list(cfg["block_out_channels"])
    g = cfg["norm_num_groups"]
    h = _conv(p, "encoder.conv_in", x)
    for i in range(len(ch)):
        for j in range(cfg["layers_per_block"]):
            h = resnet(p, f"encoder.down_blocks.{i}.resnets.{j}", h, None, g,
                       VAE_EPS)
        if i < len(ch) - 1:
            h = _conv(p, f"encoder.down_blocks.{i}.downsamplers.0.conv",
                      F.pad(h, (0, 1, 0, 1)), stride=2, padding=0)
    h = _vae_mid(p, "encoder.mid_block", h, g)
    h = F.silu(_gn(p, "encoder.conv_norm_out", h, g, VAE_EPS))
    h = _conv(p, "quant_conv", _conv(p, "encoder.conv_out", h), padding=0)
    mean, logvar = h.chunk(2, dim=1)
    return mean, torch.clamp(logvar, -30.0, 20.0)


def vae_decode(p, z, cfg: dict = VAE):
    """Images [B, 3, H, W] (about [-1, 1]) from unscaled latents `z`."""
    ch = list(cfg["block_out_channels"])
    g = cfg["norm_num_groups"]
    h = _conv(p, "decoder.conv_in", _conv(p, "post_quant_conv", z,
                                          padding=0))
    h = _vae_mid(p, "decoder.mid_block", h, g)
    for i in range(len(ch)):
        for j in range(cfg["layers_per_block"] + 1):
            h = resnet(p, f"decoder.up_blocks.{i}.resnets.{j}", h, None, g,
                       VAE_EPS)
        if i < len(ch) - 1:
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            h = _conv(p, f"decoder.up_blocks.{i}.upsamplers.0.conv", h)
    h = F.silu(_gn(p, "decoder.conv_norm_out", h, g, VAE_EPS))
    return _conv(p, "decoder.conv_out", h)


# --- DDIM and the refresh ---

def alphas_cumprod(cfg: dict = SCHEDULER) -> torch.Tensor:
    """float32 cumulative products of 1 - beta, betas scaled_linear."""
    n = cfg["num_train_timesteps"]
    betas = torch.linspace(cfg["beta_start"] ** 0.5, cfg["beta_end"] ** 0.5,
                           n, dtype=torch.float32) ** 2
    return torch.cumprod(1.0 - betas, dim=0)


def ddim_timesteps(num_train: int, steps: int, offset: int = 1) -> List[int]:
    """DDIM's "leading" timesteps of `steps` over `num_train`."""
    ratio = num_train // steps
    return [int(s) + offset for s in
            (np.arange(0, steps) * ratio).round()[::-1]]


def refresh(pu, pv, rgb, cond_rgb, text, generator: torch.Generator,
            steps: int = 20, guidance_scale: float = 7.5,
            image_guidance_scale: float = 1.5, min_step_percent: float = 0.02,
            max_step_percent: float = 0.98, unet_cfg: dict = UNET, vae_cfg: dict = VAE,
            sched: dict = SCHEDULER) -> dict:
    """One edited target: `rgb` and `cond_rgb` [H, W, 3] in [0, 1] (the
    render and the origin), `text` [2, 77, cross] (prompt, empty).
    Draws t, the encoder's sample and the start noise from `generator`
    in that order. Returns the timestep t, the final latents [1, 4, h, w] (scaled) and
    the image [H, W, 3] in [0, 1], in the state dicts' dtype."""
    dt = pu["conv_in.weight"].dtype
    dev = pu["conv_in.weight"].device
    n_train = sched["num_train_timesteps"]
    t = int(torch.randint(int(n_train * min_step_percent),
                          int(n_train * max_step_percent) + 1, (1,),
                          generator=generator, device=generator.device))
    sf = vae_cfg["scaling_factor"]

    def image(x):
        x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        return x.permute(2, 0, 1)[None].to(dt) * 2 - 1

    mean, logvar = vae_encode(pv, image(rgb), vae_cfg)
    eps = torch.randn(mean.shape, generator=generator, dtype=torch.float32,
                      device=dev).to(dt)
    lat = (mean + torch.exp(0.5 * logvar) * eps) * sf
    cond, _ = vae_encode(pv, image(cond_rgb), vae_cfg)
    ts = ddim_timesteps(t, steps, sched["steps_offset"])
    noise = torch.randn(lat.shape, generator=generator, dtype=torch.float32,
                        device=dev).to(dt)
    ac = alphas_cumprod(sched)
    a0 = float(ac[ts[0]])
    lat = math.sqrt(a0) * lat + math.sqrt(1.0 - a0) * noise
    ctx = torch.stack([text[0], text[1], text[1]]).to(dt)
    img_cond = torch.cat([cond, cond, torch.zeros_like(cond)])
    for i, s in enumerate(ts):
        x = torch.cat([torch.cat([lat] * 3), img_cond], dim=1)
        e = unet(pu, x, torch.full((3,), s, device=dev), ctx, unet_cfg)
        e_text, e_img, e_unc = e.chunk(3)
        e = (e_unc + guidance_scale * (e_text - e_img)
             + image_guidance_scale * (e_img - e_unc))
        prev = s - t // steps
        a = float(ac[s])
        ap = float(ac[prev]) if prev >= 0 else float(ac[0])
        x0 = (lat - math.sqrt(1.0 - a) * e) / math.sqrt(a)
        lat = math.sqrt(ap) * x0 + math.sqrt(1.0 - ap) * e
    img = vae_decode(pv, lat / sf, vae_cfg)
    img = (img / 2 + 0.5).clamp(0, 1)[0].permute(1, 2, 0)
    return dict(t=t, latents=lat, image=img)
