"""InstructPix2Pix without diffusers: the SD-1.5 UNet with 8 input
channels, the KL VAE and the DDIM scheduler as plain `torch.nn` modules,
and the pipeline object `InstructPix2PixGuidance` drives through its
`pipe=` seam (`guidance/diffusers_adapters.py`).

The modules follow diffusers' `UNet2DConditionModel`, `AutoencoderKL`
and `DDIMScheduler` at `timbrooks/instruct-pix2pix`'s configurations
(`UNET`, `VAE`, `SCHEDULER`) and load their state dicts under diffusers'
names. `build_pipeline` makes one on a device, in float16 as the
reference pipeline is loaded (`torch_dtype=torch.float16`), from state
dicts it is given, a file holding them, or a seed (the seeded weights of
`sd15_ref.seeded_state_dicts`: the published weights are not in the
repository). Attention is `F.scaled_dot_product_attention`. On a card
the UNet's forward is captured once per input shape as a CUDA graph and
replayed: launched eagerly from Python, its kernels took the host about
twice the forward's device time (35 against 16 ms a batch-3 call at a
64x64 latent on an H100). The capture is thread-local, so that the web
UI's frame threads may allocate, render and read back while the edit's
thread captures.

What the pipeline offers the adapter: `unet(x, t,
encoder_hidden_states=...).sample`, `vae.encode(x).latent_dist.sample()`
and `.mode()`, `vae.decode(z).sample`, `vae.config.scaling_factor`,
`vae.dtype`, `unet.dtype`, `scheduler` (`config.num_train_timesteps`,
`set_timesteps`, `timesteps`, `add_noise`, `step`, `alphas_cumprod`),
`_encode_prompt`, and `generator`, from which the adapter and the
encoder draw t, the encoder's sample and the start noise (float32
draws, cast), so that a check can replay them.

Where this departs from threestudio's `instructpix2pix_guidance.py`:
  * No text encoder: CLIP ViT-L/14 runs once per prompt and its
    tokenizer is not in the repository. The pipeline holds the prompt's
    and the empty prompt's states, and `_encode_prompt` returns
    [prompt, empty, empty] whatever prompt it is asked for.
  * The start noise is added at the first DDIM timestep, not at the
    sampled t, as the port's adapter (and the JAX package's) do.
  * The renders are not resized to 512x512: the cameras' size is used.
"""

from __future__ import annotations

import math
import types
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# unet/config.json, vae/config.json, and the DDIM settings threestudio
# runs them with (scaled_linear betas, steps_offset 1)
UNET = dict(in_channels=8, out_channels=4,
            block_out_channels=(320, 640, 1280, 1280), layers_per_block=2,
            cross_attention_dim=768, attention_head_dim=8,
            norm_num_groups=32, norm_eps=1e-5)
VAE = dict(in_channels=3, out_channels=3,
           block_out_channels=(128, 256, 512, 512), layers_per_block=2,
           latent_channels=4, norm_num_groups=32, scaling_factor=0.18215)
SCHEDULER = dict(num_train_timesteps=1000, beta_start=0.00085,
                 beta_end=0.012, steps_offset=1)
# diffusers' defaults: Transformer2DModel's group norm, the transformer
# block's layer norms, and every norm of the VAE
TRANSFORMER_GN_EPS = 1e-6
LAYER_NORM_EPS = 1e-5
VAE_EPS = 1e-6


class Output(types.SimpleNamespace):
    """diffusers' output classes: fields by attribute."""


def _dtype_of(module: nn.Module) -> torch.dtype:
    return next(module.parameters()).dtype


# --- the UNet ---

class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, temb: Optional[int],
                 groups: int, eps: float):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb, cout) if temb else None
        self.norm2 = nn.GroupNorm(groups, cout, eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb_act=None):
        """`temb_act`: the time embedding after its SiLU (the UNet takes
        it once for all its blocks)."""
        h = self.conv1(F.silu(self.norm1(x)))
        if self.time_emb_proj is not None:
            h = h + self.time_emb_proj(temb_act)[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    def __init__(self, dim: int, kv_dim: int, heads: int, bias: bool = False):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=bias)
        self.to_k = nn.Linear(kv_dim, dim, bias=bias)
        self.to_v = nn.Linear(kv_dim, dim, bias=bias)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x, ctx=None):
        ctx = x if ctx is None else ctx
        B, N, C = x.shape
        h = self.heads

        def split(t):
            return t.reshape(B, -1, h, C // h).transpose(1, 2)

        o = F.scaled_dot_product_attention(split(self.to_q(x)),
                                           split(self.to_k(ctx)),
                                           split(self.to_v(ctx)))
        return self.to_out[0](o.transpose(1, 2).reshape(B, N, C))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)

    def forward(self, x):
        val, gate = self.proj(x).chunk(2, dim=-1)
        return val * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        # diffusers' indices: GEGLU, dropout, the output projection
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(),
                                  nn.Linear(4 * dim, dim)])

    def forward(self, x):
        for m in self.net:
            x = m(x)
        return x


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, ctx_dim: int, heads: int):
        super().__init__()
        eps = LAYER_NORM_EPS
        self.norm1 = nn.LayerNorm(dim, eps)
        self.attn1 = Attention(dim, dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps)
        self.attn2 = Attention(dim, ctx_dim, heads)
        self.norm3 = nn.LayerNorm(dim, eps)
        self.ff = FeedForward(dim)

    def forward(self, x, ctx):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    def __init__(self, dim: int, ctx_dim: int, heads: int, groups: int):
        super().__init__()
        self.norm = nn.GroupNorm(groups, dim, TRANSFORMER_GN_EPS)
        self.proj_in = nn.Conv2d(dim, dim, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(dim, ctx_dim, heads)])
        self.proj_out = nn.Conv2d(dim, dim, 1)

    def forward(self, x, ctx):
        # the 1x1 projections as matrix products over the pixels, which
        # spares cuDNN's layout transforms of a convolution
        B, C, H, W = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        h = F.linear(h, self.proj_in.weight.view(C, C), self.proj_in.bias)
        for blk in self.transformer_blocks:
            h = blk(h, ctx)
        h = F.linear(h, self.proj_out.weight.view(C, C), self.proj_out.bias)
        return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


class Downsample2D(nn.Module):
    """A stride-2 3x3 convolution; `pad_right` pads (0, 1, 0, 1) first
    (the VAE's encoder), else 1 on every side (the UNet)."""

    def __init__(self, c: int, pad_right: bool = False):
        super().__init__()
        self.pad_right = pad_right
        self.conv = nn.Conv2d(c, c, 3, stride=2, padding=0 if pad_right else 1)

    def forward(self, x):
        if self.pad_right:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Block(nn.Module):
    """A down or up block: `resnets`, `attentions` (empty in the plain
    blocks) and `downsamplers` or `upsamplers` (empty at the last)."""

    def __init__(self, resnets, attentions, samplers, kind: str):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        setattr(self, kind, nn.ModuleList(samplers))
        self.kind = kind

    @property
    def samplers(self) -> nn.ModuleList:
        return getattr(self, self.kind)


class TimestepEmbedding(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(cin, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


def timestep_sinusoid(timestep, batch: int, dim: int, device) -> torch.Tensor:
    """diffusers' `Timesteps(dim, flip_sin_to_cos=True, shift 0)` of a
    timestep (a number, a one-element host tensor, or [batch] on the
    device), float32 [batch, dim]; a host timestep is read on the host,
    with no copy to the device."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=device) / half)
    t = torch.as_tensor(timestep)
    if t.device.type == "cpu" and t.numel() == 1:
        e = (float(t) * freqs)[None].expand(batch, half)
    else:
        e = t.to(device).reshape(-1).expand(batch).float()[:, None] \
            * freqs[None]
    return torch.cat([torch.cos(e), torch.sin(e)], dim=-1)


class UNet2DConditionModel(nn.Module):
    """SD-1.5's UNet: CrossAttnDown blocks but the last, which is plain;
    a cross-attention mid block; a plain up block, then CrossAttnUp
    blocks of `layers_per_block` + 1 ResNets fed by the skips."""

    def __init__(self, cfg: dict = UNET):
        super().__init__()
        self.config = types.SimpleNamespace(**cfg)
        ch = list(cfg["block_out_channels"])
        g, eps, heads = cfg["norm_num_groups"], cfg["norm_eps"], \
            cfg["attention_head_dim"]
        ctx = cfg["cross_attention_dim"]
        temb = 4 * ch[0]
        levels = len(ch)
        self.conv_in = nn.Conv2d(cfg["in_channels"], ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], temb)
        down, cin = [], ch[0]
        for i, c in enumerate(ch):
            cross = i < levels - 1
            n = cfg["layers_per_block"]
            down.append(Block(
                [ResnetBlock2D(cin if j == 0 else c, c, temb, g, eps)
                 for j in range(n)],
                [Transformer2DModel(c, ctx, heads, g) for _ in range(n)]
                if cross else [],
                [Downsample2D(c)] if cross else [], "downsamplers"))
            cin = c
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = Block(
            [ResnetBlock2D(ch[-1], ch[-1], temb, g, eps) for _ in range(2)],
            [Transformer2DModel(ch[-1], ctx, heads, g)], [], "upsamplers")
        # each up block's ResNets take the block below's output (the
        # first) or their own width, plus a skip: their own level's,
        # then the next level down's at the last (diffusers' get_up_block)
        up, rev, prev = [], ch[::-1], ch[-1]
        n = cfg["layers_per_block"] + 1
        for i, c in enumerate(rev):
            skip_in = rev[min(i + 1, levels - 1)]
            up.append(Block(
                [ResnetBlock2D((prev if j == 0 else c)
                               + (skip_in if j == n - 1 else c),
                               c, temb, g, eps) for j in range(n)],
                [Transformer2DModel(c, ctx, heads, g) for _ in range(n)]
                if i > 0 else [],
                [Upsample2D(c)] if i < levels - 1 else [], "upsamplers"))
            prev = c
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = nn.GroupNorm(g, ch[0], eps)
        self.conv_out = nn.Conv2d(ch[0], cfg["out_channels"], 3, padding=1)
        self._graphs: Dict[tuple, tuple] = {}

    @property
    def dtype(self) -> torch.dtype:
        return _dtype_of(self)

    def forward(self, sample, timestep, encoder_hidden_states):
        """The noise prediction [B, out, h, w] in the weights' dtype. On a
        card, the first call of each input shape and dtype captures the
        forward as a CUDA graph, and every call replays it."""
        dt = self.dtype
        x, ctx = sample.to(dt), encoder_hidden_states.to(dt)
        if x.is_cuda:
            return Output(sample=self._replay(x, timestep, ctx))
        t = timestep_sinusoid(timestep, x.shape[0],
                              self.conv_in.out_channels, x.device)
        return Output(sample=self._body(x, t, ctx))

    def _replay(self, x, timestep, ctx):
        key = (tuple(x.shape), tuple(ctx.shape), x.dtype, x.device)
        if key not in self._graphs:
            self._graphs[key] = self._capture(x, ctx)
        graph, sx, st, sctx, out = self._graphs[key]
        sx.copy_(x)
        sctx.copy_(ctx)
        t = torch.as_tensor(timestep)
        if t.device.type == "cpu" and t.numel() == 1:
            st.fill_(float(t))      # no copy to the device
        else:
            st.copy_(t.to(st.device).reshape(-1).expand(st.shape[0]))
        graph.replay()
        return out.clone()

    def _capture(self, x, ctx) -> tuple:
        """A graph of the forward on static inputs (the latents, the
        timesteps as float32 [B], the text states), after one eager run
        on a side stream that loads the libraries' plans."""
        sx, sctx = x.clone(), ctx.clone()
        st = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
        C = self.conv_in.out_channels
        side = torch.cuda.Stream(device=x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            self._body(sx, timestep_sinusoid(st, x.shape[0], C, x.device),
                       sctx)
        torch.cuda.current_stream(x.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread-local: another thread's allocations, syncs and launches
        # (a served frame) neither fail nor spoil this capture
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = self._body(sx, timestep_sinusoid(st, x.shape[0], C,
                                                   x.device), sctx)
        return graph, sx, st, sctx, out

    def _body(self, x, t_sinusoid, ctx):
        temb = F.silu(self.time_embedding(t_sinusoid.to(x.dtype)))
        h = self.conv_in(x)
        skips = [h]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(h, temb)
                if len(blk.attentions):
                    h = blk.attentions[j](h, ctx)
                skips.append(h)
            for s in blk.samplers:
                h = s(h)
                skips.append(h)
        m = self.mid_block
        h = m.resnets[1](m.attentions[0](m.resnets[0](h, temb), ctx), temb)
        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if len(blk.attentions):
                    h = blk.attentions[j](h, ctx)
            for s in blk.samplers:
                h = s(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


# --- the VAE ---

class VAEAttention(nn.Module):
    """The VAE's single-head self-attention over the pixels, with its
    own group norm and the residual."""

    def __init__(self, c: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, c, VAE_EPS)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).reshape(B, C, H * W).transpose(1, 2)
        o = F.scaled_dot_product_attention(
            self.to_q(h)[:, None], self.to_k(h)[:, None],
            self.to_v(h)[:, None])[:, 0]
        return x + self.to_out[0](o).transpose(1, 2).reshape(B, C, H, W)


def _vae_mid(c: int, groups: int) -> Block:
    return Block([ResnetBlock2D(c, c, None, groups, VAE_EPS)
                  for _ in range(2)], [VAEAttention(c, groups)], [],
                 "upsamplers")


def _run_mid(m: Block, h):
    return m.resnets[1](m.attentions[0](m.resnets[0](h)))


class Encoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        ch, g = list(cfg["block_out_channels"]), cfg["norm_num_groups"]
        n = cfg["layers_per_block"]
        self.conv_in = nn.Conv2d(cfg["in_channels"], ch[0], 3, padding=1)
        blocks, cin = [], ch[0]
        for i, c in enumerate(ch):
            blocks.append(Block(
                [ResnetBlock2D(cin if j == 0 else c, c, None, g, VAE_EPS)
                 for j in range(n)], [],
                [Downsample2D(c, pad_right=True)] if i < len(ch) - 1 else [],
                "downsamplers"))
            cin = c
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _vae_mid(ch[-1], g)
        self.conv_norm_out = nn.GroupNorm(g, ch[-1], VAE_EPS)
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg["latent_channels"], 3,
                                  padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                h = res(h)
            for s in blk.samplers:
                h = s(h)
        h = _run_mid(self.mid_block, h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        ch, g = list(cfg["block_out_channels"]), cfg["norm_num_groups"]
        n = cfg["layers_per_block"] + 1
        rev = ch[::-1]
        self.conv_in = nn.Conv2d(cfg["latent_channels"], rev[0], 3, padding=1)
        self.mid_block = _vae_mid(rev[0], g)
        blocks, cin = [], rev[0]
        for i, c in enumerate(rev):
            blocks.append(Block(
                [ResnetBlock2D(cin if j == 0 else c, c, None, g, VAE_EPS)
                 for j in range(n)], [],
                [Upsample2D(c)] if i < len(rev) - 1 else [], "upsamplers"))
            cin = c
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = nn.GroupNorm(g, ch[0], VAE_EPS)
        self.conv_out = nn.Conv2d(ch[0], cfg["out_channels"], 3, padding=1)

    def forward(self, z):
        h = _run_mid(self.mid_block, self.conv_in(z))
        for blk in self.up_blocks:
            for res in blk.resnets:
                h = res(h)
            for s in blk.samplers:
                h = s(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class DiagonalGaussian:
    """The encoder's posterior; `sample` draws float32 noise from the
    pipeline's generator and casts it."""

    def __init__(self, moments, generator: Optional[torch.Generator]):
        self.mean, logvar = moments.chunk(2, dim=1)
        self.std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
        self.generator = generator

    def sample(self):
        eps = torch.randn(self.mean.shape, generator=self.generator,
                          dtype=torch.float32, device=self.mean.device)
        return self.mean + self.std * eps.to(self.mean.dtype)

    def mode(self):
        return self.mean


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: dict = VAE):
        super().__init__()
        self.config = types.SimpleNamespace(**cfg)
        lat = cfg["latent_channels"]
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)
        self.generator: Optional[torch.Generator] = None

    @property
    def dtype(self) -> torch.dtype:
        return _dtype_of(self)

    def encode(self, x):
        moments = self.quant_conv(self.encoder(x.to(self.dtype)))
        return Output(latent_dist=DiagonalGaussian(moments, self.generator))

    def decode(self, z):
        return Output(sample=self.decoder(self.post_quant_conv(
            z.to(self.dtype))))


# --- DDIM ---

class DDIMScheduler:
    """diffusers' `DDIMScheduler` as threestudio runs it: scaled_linear
    betas, "leading" timesteps plus `steps_offset`, epsilon prediction,
    eta 0, no clipping, alpha_prod at step 0 past the last step
    (`set_alpha_to_one` false). `step` reads `config.num_train_timesteps`
    for the stride, as diffusers does, so the adapter's override of it
    takes effect."""

    def __init__(self, cfg: dict = SCHEDULER):
        self.config = types.SimpleNamespace(**cfg)
        n = cfg["num_train_timesteps"]
        betas = torch.linspace(cfg["beta_start"] ** 0.5,
                               cfg["beta_end"] ** 0.5, n,
                               dtype=torch.float32) ** 2
        self.alphas_cumprod = torch.cumprod(1.0 - betas, dim=0)
        self.final_alpha_cumprod = self.alphas_cumprod[0]
        self.num_inference_steps: Optional[int] = None
        self.timesteps = torch.arange(n - 1, -1, -1)

    def set_timesteps(self, num_inference_steps: int) -> None:
        n = self.config.num_train_timesteps
        if num_inference_steps > n:
            raise ValueError(f"{num_inference_steps} steps over {n} "
                             "training timesteps")
        self.num_inference_steps = num_inference_steps
        ratio = n // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * ratio).round()[::-1]
        self.timesteps = torch.from_numpy(
            ts.astype(np.int64) + self.config.steps_offset)

    def add_noise(self, original, noise, timesteps):
        a = self.alphas_cumprod.to(original.device, original.dtype)[
            timesteps.to(original.device)]
        a = a.reshape(-1, *([1] * (original.ndim - 1)))
        return a ** 0.5 * original + (1 - a) ** 0.5 * noise

    def step(self, model_output, timestep, sample):
        t = int(timestep)
        prev = t - self.config.num_train_timesteps // self.num_inference_steps
        a = self.alphas_cumprod[t]
        ap = self.alphas_cumprod[prev] if prev >= 0 \
            else self.final_alpha_cumprod
        x0 = (sample - float((1 - a) ** 0.5) * model_output) \
            / float(a ** 0.5)
        return Output(prev_sample=float(ap ** 0.5) * x0
                      + float((1 - ap) ** 0.5) * model_output)


# --- the pipeline ---

class InstructPix2PixPipeline:
    """The parts of diffusers' `StableDiffusionInstructPix2PixPipeline`
    that `InstructPix2PixGuidance` uses, with the prompt's text states
    given in place of a text encoder."""

    def __init__(self, unet: UNet2DConditionModel, vae: AutoencoderKL,
                 scheduler: DDIMScheduler, text_states: torch.Tensor,
                 generator: torch.Generator):
        self.unet, self.vae, self.scheduler = unet, vae, scheduler
        self.text_states = text_states.to(unet.dtype)
        self.generator = generator
        vae.generator = generator

    def _encode_prompt(self, prompt, device, num_images_per_prompt,
                       do_classifier_free_guidance, negative_prompt=None):
        """[prompt, empty, empty]: the text, image and unconditional rows
        of the 3-way guidance."""
        p, empty = self.text_states[0], self.text_states[1]
        return torch.stack([p, empty, empty]).to(device)


def _module(cls, cfg: dict, sd: Dict[str, torch.Tensor], device,
            dtype: torch.dtype) -> nn.Module:
    """`cls(cfg)` built on the meta device, then given `sd`'s tensors in
    `dtype` on `device` (strict: every name, no other)."""
    with torch.device("meta"):
        m = cls(cfg)
    m.load_state_dict({k: v.to(device=device, dtype=dtype)
                       for k, v in sd.items()}, strict=True, assign=True)
    return m.requires_grad_(False).eval()


def build_pipeline(device="cuda", seed: Optional[int] = None,
                   weights: Optional[str] = None, state_dicts=None,
                   unet_dtype: str = "float16", vae_dtype: str = "float16",
                   generator_seed: int = 0, unet_config: dict = UNET,
                   vae_config: dict = VAE,
                   scheduler_config: dict = SCHEDULER
                   ) -> InstructPix2PixPipeline:
    """The native pipeline on `device`, its weights from exactly one of:
    `state_dicts` (UNet state dict, VAE state dict, text states [2, 77,
    768]), `weights` (a `torch.save`d dict of those under "unet", "vae",
    "text_states") or `seed` (`sd15_ref.seeded_state_dicts`). Its
    generator, on `device`, is seeded with `generator_seed`."""
    given = [x is not None for x in (seed, weights, state_dicts)]
    if sum(given) != 1:
        raise ValueError("give exactly one of seed, weights, state_dicts")
    device = torch.device(device)
    if seed is not None:
        from gaussianeditor_tpu_torch.guidance.sd15_ref import (
            seeded_state_dicts,
        )

        state_dicts = seeded_state_dicts(seed, device, unet_config,
                                             vae_config)
    elif weights is not None:
        d = torch.load(weights, map_location=device, weights_only=True)
        state_dicts = (d["unet"], d["vae"], d["text_states"])
    unet_sd, vae_sd, text = state_dicts
    udt, vdt = getattr(torch, unet_dtype), getattr(torch, vae_dtype)
    unet = _module(UNet2DConditionModel, unet_config, unet_sd, device, udt)
    vae = _module(AutoencoderKL, vae_config, vae_sd, device, vdt)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(generator_seed))
    return InstructPix2PixPipeline(unet, vae, DDIMScheduler(scheduler_config),
                                   text.to(device), gen)
