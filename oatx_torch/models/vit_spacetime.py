"""SpaceTimeTransformer — divided space-time ViT video tower
(port of oatx/models/vit_spacetime.py:25-358).

Block wiring (:166-188):
    u = x + time_attn(norm3(x))
    r = x + space_attn(norm1(u))        # residual from x, not u
    out = r + ln_mlp(norm2, r)          # kernel 1 (oatx's fused_mlp default)
With `fused_mlp=False` the MLP is the plain chain oatx runs then (its
`mlp(layer_norm(r))`, :187): LayerNorm, fc1, exact-erf GELU, fc2, biases
in the compute dtype. Space attention runs kernel 2 (ops/kernels/space_attention.py). With
`fused_qkv=True` each LN→qkv pair runs as kernel 3 (ops/kernels/ln_linear.py,
oatx :168-177); the port's one CLS-first stream is the layout oatx falls back
to under `fused_qkv` (:297-299). Every kernel carries its gradient, so the
tower trains. Parameter
names follow the reference state_dict (`blocks.N.{norm1,norm2,norm3,attn,
timeattn,mlp}.*`, `patch_embed.proj`, `cls_token`, `pos_embed`,
`temporal_embed`, `norm`), so `load_state_dict(strict=True)` is the bridge.

Remat (oatx :257-268, applied per block at :305-308) wraps each block in
`torch.utils.checkpoint.checkpoint(use_reentrant=False)`:
    full      keep the block's input only, recompute the rest (oatx policy None)
    dots      also keep the outputs of 2-D weight products (aten mm/addmm):
              jax's checkpoint_dots_with_no_batch_dims
    dots_all  also keep batched products (aten bmm, the attention einsums):
              jax's checkpoint_dots
The kernels launch outside PyTorch's dispatcher, so no policy can keep their
outputs: every policy runs them again in the backward, as oatx recomputes a
pallas_call (it is not a dot). The selective policies run a Python policy
call per ATen op in the forward and its recompute; on the H100 that host
time outweighs what they save (PERF.md §5). `scan_blocks` is a compile-time
choice in JAX; here it is the same loop over the blocks.

With `region_tap_layer` = K the tower also returns `region`, the patch
tokens after block K through their own `region_norm` (oatx :311-341, the
object-aware variants' layer-K tap; the CLS row is left out). The tap sits
between blocks, outside any block's checkpoint, so every remat policy and
`fwd_chunk`'s outer checkpoint recompute it as they recompute the blocks.

The config accepts every oatx key. The layout knobs (`cls_position`,
`split_cls_stream`) leave outputs unchanged and are ignored: the port has one
token order, CLS first.

Pipeline stages (`pipeline_stages` P > 1, oatx :312-321; put in place by
parallel/sharding.py `place_pipeline` through `enable_pipeline`): the tower
keeps its stage's blocks only (`blocks[i]` is None for the others' i) and
runs its block loop through parallel/pipeline.py `pipeline_blocks` in
`pipeline_microbatches` micro-batches, remat wrapping each block inside the
stage as in the loop; the embedding, the final norm and the pooling run on
every stage. P must equal the model axis' width, and a region tap is
refused, as oatx asserts; a tower with P > 1 that was not placed raises at
its forward. `pp_partial_params` are the embedding's parameters, whose
gradient only stage 0 computes.

Tensor parallelism (parallel/tensor.py; put in place by
parallel/sharding.py through `enable_model_parallel`): each block runs its
rank's heads of both attentions (qkv rows, proj input columns) and its rows
of the MLP's hidden width (fc1 rows, fc2 columns; kernel 1 on them with a
zero fc2 bias, b2 added once after the sum), between the model group's
`enter` / `leave` collectives. Both are numerically the unsharded block.
Gradients that a rank holds in part are summed over the model group after
the backward (`tp_partial_params`): the column-parallel biases (held whole,
used by rows), and every LayerNorm whose affine runs after the point where
`enter` sits: norm2 inside kernel 1, norm1 / norm3 inside kernel 3 under
`fused_qkv`.

`sequence_parallel` with a model axis (oatx's `_sp_constrain`, :270-282;
without one it is a no-op there and here): the residual stream between the
blocks is token-sharded over the model group. The CLS-first stream of
T = 1 + F·N tokens (785 at ViT-B/16 over 4 frames, 1025 at ViT-H/14, neither
divisible by 4) is padded with zero rows to a multiple of the group's
width: rank m holds rows [m·t, (m + 1)·t), t = ⌈T/mp⌉, the padding on the
last rank. The norms and residual adds run on those rows (zero padding rows
stay zero and never reach a product); each sublayer gathers the rows
before its products and reduce-scatters after the row-parallel one, so
every block LayerNorm and row-parallel bias then sums its gradient over
the group too. The region tap and the final norm read a gathered stream.
Under remat a block's saved input is its rank's rows, and the recompute
runs the block's collectives again.

`inflate_spatial_embed` / `inflate_temporal_embed` (oatx :413-454) resize the
positional embeddings of a checkpoint with another patch or frame count.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from oatx_torch import DeviceLike, resolve_device
from oatx_torch.ops.attention import divided_attention
from oatx_torch.ops.kernels.ln_mlp import ln_mlp
from oatx_torch.ops.layers import LayerNorm, Linear, gelu, linear, patch_embed_conv, \
    trunc_normal_
from oatx_torch.parallel import collectives as coll
from oatx_torch.parallel import tensor as tpl
from oatx_torch.parallel.pipeline import pipeline_blocks

LN_EPS = 1e-6  # reference norm_layer = partial(nn.LayerNorm, eps=1e-6)


@dataclasses.dataclass(frozen=True)
class SpaceTimeViTConfig:
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    num_frames: int = 4               # maximum frames (temporal embed length)
    time_init: str = "zeros"          # 'zeros' | 'random'
    region_tap_layer: Optional[int] = None
    pooling: str = "cls"              # 'cls' | 'cls_mean_half'
    remat: bool = False
    remat_policy: str = "full"
    scan_blocks: bool = False
    cls_position: str = "last"        # layout only; the port is CLS-first
    pipeline_stages: int = 1
    pipeline_microbatches: int = 4
    fused_qkv: bool = False
    sequence_parallel: bool = False   # token-sharded stream over a model axis
    split_cls_stream: bool = True     # layout only; the port keeps one stream
    fused_mlp: bool = True            # LN→fc1→GELU→fc2 through kernel 1

    @property
    def patches_per_frame(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


_SAVED_OPS = {  # remat_policy → aten products whose outputs the backward keeps
    "full": (),
    "dots": ("mm", "addmm"),
    "dots_all": ("mm", "addmm", "bmm", "baddbmm"),
}


def _save_products(saved, ctx, op, *args, **kwargs):
    name = op.overloadpacket.__name__
    return (ckpt.CheckpointPolicy.MUST_SAVE if name in saved
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_context_fn(policy: str):
    """checkpoint's `context_fn` for oatx's remat_policy (module docstring)."""
    if policy not in _SAVED_OPS:
        raise ValueError(f"unknown remat_policy {policy!r} (expected full|dots|dots_all)")
    saved = _SAVED_OPS[policy]
    if not saved:
        return ckpt.noop_context_fn
    return functools.partial(ckpt.create_selective_checkpoint_contexts,
                             functools.partial(_save_products, saved))


class Attention(nn.Module):
    """VarAttention parameters: fused qkv and the output projection."""

    def __init__(self, dim: int, zeros: bool, device, generator):
        super().__init__()
        self.qkv = Linear(dim, 3 * dim, device, generator)
        self.proj = Linear(dim, dim, device, generator)
        if zeros:
            # reference VarAttention initialize='zeros': qkv zeroed, proj
            # weight filled with ONES, proj bias zero (oatx :110-118)
            with torch.no_grad():
                self.qkv.weight.zero_()
                self.proj.weight.fill_(1.0)

    def forward(self, x: torch.Tensor, num_heads: int, num_frames: int,
                mode: str, norm: Optional[LayerNorm] = None,
                axis: Optional[tpl.ModelAxis] = None) -> torch.Tensor:
        """`norm` given: x is pre-norm and LN→qkv runs as kernel 3. `axis`
        given: the rank's heads (of `num_heads` in all), its qkv bias rows,
        the projection without its bias (a partial sum)."""
        ln = {} if norm is None else dict(ln_w=norm.weight, ln_b=norm.bias,
                                          ln_eps=norm.eps)
        if axis is None:
            return divided_attention(x, self.qkv.weight, self.qkv.bias,
                                     self.proj.weight, self.proj.bias,
                                     num_heads, num_frames, mode, **ln)
        return divided_attention(x, self.qkv.weight, tpl.local_rows(self.qkv.bias, axis, 3),
                                 self.proj.weight, None, axis.heads(num_heads),
                                 num_frames, mode, **ln)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device, generator):
        super().__init__()
        self.fc1 = Linear(dim, hidden, device, generator)
        self.fc2 = Linear(hidden, dim, device, generator)


class SpaceTimeBlock(nn.Module):
    tp: Optional[tpl.ModelAxis] = None  # the model axis, once enable_model_parallel ran

    def __init__(self, cfg: SpaceTimeViTConfig, device, generator):
        super().__init__()
        dim = cfg.embed_dim
        self.cfg = cfg
        self.norm1 = LayerNorm(dim, LN_EPS, device)
        self.norm2 = LayerNorm(dim, LN_EPS, device)
        self.norm3 = LayerNorm(dim, LN_EPS, device)
        self.attn = Attention(dim, False, device, generator)
        self.timeattn = Attention(dim, cfg.time_init == "zeros", device, generator)
        self.mlp = Mlp(dim, int(dim * cfg.mlp_ratio), device, generator)

    def forward(self, x: torch.Tensor, num_frames: int) -> torch.Tensor:
        if self.tp is not None:
            return self._forward_tp(x, num_frames)
        h = self.cfg.num_heads
        if self.cfg.fused_qkv:
            u = x + self.timeattn(x, h, num_frames, "time", self.norm3)
            r = x + self.attn(u, h, num_frames, "space", self.norm1)
        else:
            u = x + self.timeattn(self.norm3(x), h, num_frames, "time")
            r = x + self.attn(self.norm1(u), h, num_frames, "space")
        m, n2 = self.mlp, self.norm2
        if not self.cfg.fused_mlp:
            return r + mlp_plain(self.norm2(r), m.fc1.weight, m.fc1.bias,
                                 m.fc2.weight, m.fc2.bias)
        return r + ln_mlp(r, n2.weight, n2.bias, m.fc1.weight, m.fc1.bias,
                          m.fc2.weight, m.fc2.bias, LN_EPS)

    def _forward_tp(self, x: torch.Tensor, num_frames: int) -> torch.Tensor:
        """The block on this rank's heads and hidden rows (module docstring);
        x is the whole stream, or this rank's token rows under sequence
        parallelism."""
        axis, cfg = self.tp, self.cfg
        total = 1 + num_frames * cfg.patches_per_frame
        h = cfg.num_heads

        def attention(mod, y, mode, norm=None):
            part = mod(tpl.enter(axis, y, total), h, num_frames, mode, norm, axis)
            return tpl.leave(axis, part) + mod.proj.bias.to(y.dtype)

        if cfg.fused_qkv:
            u = x + attention(self.timeattn, x, "time", self.norm3)
            r = x + attention(self.attn, u, "space", self.norm1)
        else:
            u = x + attention(self.timeattn, self.norm3(x), "time")
            r = x + attention(self.attn, self.norm1(u), "space")
        m, n2 = self.mlp, self.norm2
        b1 = tpl.local_rows(m.fc1.bias, axis)
        if cfg.fused_mlp:
            part = ln_mlp(tpl.enter(axis, r, total), n2.weight, n2.bias, m.fc1.weight, b1,
                          m.fc2.weight, torch.zeros_like(m.fc2.bias), LN_EPS)
        else:
            part = mlp_plain(tpl.enter(axis, self.norm2(r), total), m.fc1.weight, b1,
                             m.fc2.weight, None)
        return r + (tpl.leave(axis, part) + m.fc2.bias.to(r.dtype))

    def tp_partial_params(self):
        """The parameters whose gradient each rank of the model group holds
        in part (module docstring), to be summed over the group."""
        cfg = self.cfg
        out = [self.attn.qkv.bias, self.timeattn.qkv.bias, self.mlp.fc1.bias]
        norms = []
        if cfg.fused_mlp:
            norms.append(self.norm2)
        if cfg.fused_qkv:
            norms += [self.norm1, self.norm3]
        if self.tp is not None and self.tp.sequence_parallel:
            norms = [self.norm1, self.norm2, self.norm3]
            out += [self.attn.proj.bias, self.timeattn.proj.bias, self.mlp.fc2.bias]
        return out + [p for n in norms for p in (n.weight, n.bias)]


def mlp_plain(z: torch.Tensor, fc1_w, fc1_b, fc2_w, fc2_b) -> torch.Tensor:
    """fc1 → exact-erf GELU → fc2 on normed z, biases in the compute dtype
    (oatx layers.mlp, its fused_mlp=False path); a None bias is left out."""
    return linear(gelu(linear(z, fc1_w, fc1_b)), fc2_w, fc2_b)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: SpaceTimeViTConfig, device, generator):
        super().__init__()
        self.patch_size = cfg.patch_size
        self.proj = nn.Module()
        self.proj.weight = nn.Parameter(trunc_normal_(torch.empty(
            cfg.embed_dim, cfg.in_chans, cfg.patch_size, cfg.patch_size,
            device=device), generator))
        self.proj.bias = nn.Parameter(torch.zeros(cfg.embed_dim, device=device))

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        return patch_embed_conv(frames, self.proj.weight, self.proj.bias,
                                self.patch_size)


class SpaceTimeTransformer(nn.Module):
    tp: Optional[tpl.ModelAxis] = None  # the model axis, once enable_model_parallel ran
    pp = None  # the rank's Layout, once enable_pipeline ran

    def __init__(self, cfg: SpaceTimeViTConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.pipeline_stages > 1 and cfg.region_tap_layer is not None:
            raise ValueError("pipeline parallelism does not support region taps")
        if cfg.pooling not in ("cls", "cls_mean_half"):
            raise ValueError(f"unknown pooling {cfg.pooling!r}")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        self.cfg = cfg
        d, n = cfg.embed_dim, cfg.patches_per_frame
        self.patch_embed = PatchEmbed(cfg, device, generator)
        self.cls_token = nn.Parameter(trunc_normal_(
            torch.empty(1, 1, d, device=device), generator))
        self.pos_embed = nn.Parameter(trunc_normal_(
            torch.empty(1, n + 1, d, device=device), generator))
        self.temporal_embed = nn.Parameter(
            torch.zeros(1, cfg.num_frames, d, device=device))
        self.blocks = nn.ModuleList(
            SpaceTimeBlock(cfg, device, generator) for _ in range(cfg.depth))
        self.norm = LayerNorm(d, LN_EPS, device)
        if cfg.region_tap_layer is not None:
            self.region_norm = LayerNorm(d, LN_EPS, device)
        self._remat_ctx = remat_context_fn(cfg.remat_policy) if cfg.remat else None

    def embed(self, video: torch.Tensor) -> torch.Tensor:
        """video (B, F, H, W, C) NHWC → tokens (B, 1 + F·N, D), CLS first, with
        the spatial pos-embed tiled per frame and the temporal embed repeated
        per patch (oatx :223-254)."""
        cfg = self.cfg
        b, f, hh, ww, c = video.shape
        if f > cfg.num_frames:
            raise ValueError(f"{f} frames > configured max {cfg.num_frames}")
        n, d, dt = cfg.patches_per_frame, cfg.embed_dim, video.dtype
        tokens = self.patch_embed(video.reshape(b * f, hh, ww, c))
        tokens = tokens.reshape(b, f * n, d)
        pos = self.pos_embed.to(dt)
        tile_pos = pos[:, 1:].repeat(1, cfg.num_frames, 1)
        tile_temporal = self.temporal_embed.to(dt).repeat_interleave(n, dim=1)
        patch_pos = (tile_pos + tile_temporal)[:, : f * n]
        cls = self.cls_token.to(dt).expand(b, 1, d) + pos[:, :1]
        return torch.cat([cls, tokens + patch_pos], dim=1)

    def forward(self, video: torch.Tensor) -> Dict[str, torch.Tensor]:
        """video (B, F, H, W, C) in the compute dtype → dict(cls=(B, D) pooled
        per cfg.pooling, patches=(B, F·N, D) after the final norm, and with
        region_tap_layer K, region=(B, F·N, D): block K's patch tokens
        through region_norm)."""
        f = video.shape[1]
        x = self.embed(video)
        total = x.shape[1]
        sp = self.tp is not None and self.tp.sequence_parallel
        whole = (lambda y: coll.gather_tokens_whole(y, self.tp.group, total)) if sp \
            else (lambda y: y)
        if sp:
            x = coll.split_tokens(x, self.tp.group)
        remat = self._remat_ctx is not None and torch.is_grad_enabled()

        def run(blk):
            if remat:
                return lambda h: ckpt.checkpoint(blk, h, f, use_reentrant=False,
                                                 context_fn=self._remat_ctx)
            return lambda h: blk(h, f)

        k = self.cfg.region_tap_layer
        out: Dict[str, torch.Tensor] = {}
        if self.cfg.pipeline_stages > 1:
            if self.pp is None:
                raise ValueError("pipeline_stages must equal the registered mesh's model "
                                 "axis: place the tower on its pipeline stages "
                                 "(parallel/sharding.place_pipeline)")
            mine = [blk for blk in self.blocks if blk is not None]
            x = pipeline_blocks([run(blk) for blk in mine], x, self.cfg.pipeline_stages,
                                self.cfg.pipeline_microbatches, self.pp,
                                [p for blk in mine for p in blk.parameters()])
        else:
            for i, blk in enumerate(self.blocks):
                x = run(blk)(x)
                if k is not None and i == k - 1:
                    out["region"] = self.region_norm(whole(x)[:, 1:])
        x = self.norm(whole(x))
        cls, patches = x[:, 0], x[:, 1:]
        if self.cfg.pooling == "cls_mean_half":
            cls = 0.5 * cls + 0.5 * patches.mean(dim=1)
        out["cls"], out["patches"] = cls, patches
        return out


    def enable_model_parallel(self, axis: tpl.ModelAxis, split) -> None:
        """Run the blocks tensor-parallel over `axis` (module docstring),
        token-sharded when cfg.sequence_parallel. `split`: the names (under
        this module) of the parameters parallel/sharding.py splits; every
        block's qkv, proj, fc1 and fc2 weight must be among them."""
        cfg = self.cfg
        if cfg.num_heads % axis.size:
            raise ValueError(f"model_parallel={axis.size} does not divide the video "
                             f"tower's {cfg.num_heads} heads")
        want = [f"blocks.{i}.{m}.{w}.weight" for i in range(cfg.depth)
                for m, w in (("attn", "qkv"), ("attn", "proj"), ("timeattn", "qkv"),
                             ("timeattn", "proj"), ("mlp", "fc1"), ("mlp", "fc2"))]
        missing = [n for n in want if n not in split]
        if missing:
            raise ValueError(f"model_parallel={axis.size} does not divide the widths of "
                             f"{missing[:3]}")
        axis = dataclasses.replace(axis, sequence_parallel=cfg.sequence_parallel)
        self.tp = axis
        for blk in self.blocks:
            blk.tp = axis

    def tp_partial_params(self):
        return [p for blk in self.blocks for p in blk.tp_partial_params()]

    def enable_pipeline(self, layout) -> None:
        """Keep the blocks of `layout`'s stage (parallel/mesh.py
        `stage_blocks`) and drop the others; the forward then runs the
        stack through parallel/pipeline.py (module docstring)."""
        cfg = self.cfg
        if cfg.pipeline_stages != layout.model_parallel:
            raise ValueError(f"pipeline_stages={cfg.pipeline_stages} must equal the "
                             f"registered mesh's model axis ({layout.model_parallel})")
        mine = layout.stage_blocks(cfg.depth)
        for i in range(cfg.depth):
            if i not in mine:
                self.blocks._modules[str(i)] = None
        self.pp = layout

    def pp_partial_params(self):
        """The embedding's parameters: under pipeline stages only stage 0
        computes their gradient, which the model group sums."""
        return [self.patch_embed.proj.weight, self.patch_embed.proj.bias, self.cls_token,
                self.pos_embed, self.temporal_embed]


def inflate_spatial_embed(pos_embed: torch.Tensor, target_patches: int) -> torch.Tensor:
    """pos_embed (1, 1 + n, D) → (1, 1 + target_patches, D): the (g, g) grid
    resized bilinearly (jax.image.resize's, antialiased when it shrinks), the
    CLS row kept (oatx :413-429)."""
    n = pos_embed.shape[1] - 1
    if n == target_patches:
        return pos_embed
    g_src, g_dst = round(n ** 0.5), round(target_patches ** 0.5)
    if g_src * g_src != n or g_dst * g_dst != target_patches:
        raise ValueError(f"non-square patch grids: {n} → {target_patches}")
    cls, grid = pos_embed[:, :1], pos_embed[:, 1:]
    grid = grid.reshape(1, g_src, g_src, -1).permute(0, 3, 1, 2).float()
    grid = F.interpolate(grid, size=(g_dst, g_dst), mode="bilinear",
                         align_corners=False, antialias=g_dst < g_src)
    grid = grid.permute(0, 2, 3, 1).reshape(1, target_patches, -1).to(pos_embed.dtype)
    return torch.cat([cls, grid], dim=1)


def inflate_temporal_embed(temporal_embed: torch.Tensor, target_frames: int,
                           mode: str = "zeros") -> torch.Tensor:
    """temporal_embed (1, F, D) → (1, target_frames, D) (oatx :432-454, the
    reference's _inflate_positional_embeds): a shrink truncates; a growth pads
    with zeros ('zeros'), repeats the nearest frame ('interp') or interpolates
    linearly ('bilinear')."""
    src = temporal_embed
    load_frames = src.shape[1]
    if load_frames == target_frames:
        return src
    if load_frames > target_frames:
        return src[:, :target_frames]
    if mode == "zeros":
        pad = src.new_zeros(src.shape[0], target_frames - load_frames, src.shape[2])
        return torch.cat([src, pad], dim=1)
    if mode in ("interp", "bilinear"):
        kw = (dict(mode="nearest-exact") if mode == "interp"
              else dict(mode="linear", align_corners=False))
        out = F.interpolate(src.transpose(1, 2).float(), size=target_frames, **kw)
        return out.transpose(1, 2).to(src.dtype)
    raise NotImplementedError(f"temporal fix mode {mode!r}")
