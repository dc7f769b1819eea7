"""DINOv2 Vision Transformer, the frozen monocular backbone (channel-first input).

The port of the JAX package's ``models/dinov2.py``: patch embedding, cls
token, bicubic pos-embed interpolation with the +0.1 scale-factor offset,
pre-norm blocks with LayerScale, and intermediate-layer taps.

Attention over N > 1024 tokens takes the implementation ``vit_attention``
names: "flash" the flash-attention kernel (``ops/kernels.py:
flash_attention``, bf16 or fp32, on CUDA tensors when ``use_pallas`` is set;
its plain twin otherwise), "flash_sharded" the same kernel per (batch, heads)
shard of the active mesh (``ops/sharded.py:flash_attention_sharded``),
"chunked" the online softmax over key chunks, "dense" the dense form. "auto"
is resolved at every call, as the JAX package resolves it per trace:
"flash_sharded" under a mesh of more than one entry, a device ``Mesh`` or
a ``RankMesh``, "flash" otherwise. Under a ``RankMesh`` every rank runs the
whole ViT on its batch rows and, where its ``spatial`` axis divides the
heads, attends over its own heads (K3s), gathered over its spatial group;
``vit_attention="flash"`` keeps K3 over all heads on every rank.
Smaller N takes the dense form, as the JAX package decides.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from foundationstereo_torch.config import VIT_CONFIGS
from foundationstereo_torch.models.layers import Conv2d, LayerNorm, Linear, gelu
from foundationstereo_torch.ops import kernels, sharded
from foundationstereo_torch.ops.resize import interp_matrix_np
from foundationstereo_torch.parallel.mesh import current_mesh

_VIT_ATTENTION_IMPLS = ("auto", "dense", "chunked", "flash", "flash_sharded")


def resolve_vit_attention(impl: str) -> str:
    """The attention ``impl`` names, with "auto" resolved for this call from
    the active mesh (the JAX package's ``resolve_vit_attention``). Unknown
    values raise."""
    if impl not in _VIT_ATTENTION_IMPLS:
        raise ValueError(f"vit_attention={impl!r} not in {_VIT_ATTENTION_IMPLS}")
    if impl != "auto":
        return impl
    mesh = current_mesh()
    return "flash_sharded" if mesh is not None and mesh.size > 1 else "flash"


def _plain_heads(qkv: torch.Tensor, scale: float, h0: int, n_heads: int) -> torch.Tensor:
    return kernels.flash_attention_plain(qkv[:, :, :, h0:h0 + n_heads], scale)


def chunked_attention(qkv: torch.Tensor, scale: float, chunk: int = 512) -> torch.Tensor:
    """Online-softmax attention over key chunks, the JAX package's
    ``chunked_attention``: no (N, N) logits, fp32 statistics and accumulators.
    qkv (B, N, 3, H, Dh) -> (B, N, H, Dh) in qkv's dtype."""
    q, k, v = qkv.unbind(2)
    B, N, H, D = q.shape
    qf = q.float()
    m = torch.full((B, H, N), -1e30, device=qkv.device)
    l = torch.zeros((B, H, N), device=qkv.device)
    acc = torch.zeros((B, H, N, D), device=qkv.device)
    for s0 in range(0, N, chunk):
        s = torch.einsum("bnhd,bmhd->bhnm", qf, k[:, s0:s0 + chunk].float()) * scale
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhnm,bmhd->bhnd", p.to(v.dtype).float(), v[:, s0:s0 + chunk].float())
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).transpose(1, 2).to(qkv.dtype)


class Attention(nn.Module):
    """Joint-qkv multi-head self-attention."""

    def __init__(self, dim, num_heads, attention="auto", use_kernel=True, cdt=torch.float32):
        super().__init__()
        resolve_vit_attention(attention)        # an unknown value raises here
        self.num_heads = num_heads
        self.attention = attention
        self.use_kernel = use_kernel
        self.qkv = Linear(dim, 3 * dim, cdt=cdt)
        self.proj = Linear(dim, dim, cdt=cdt)

    def forward(self, x):
        B, N, C = x.shape
        hd = C // self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, hd)
        scale = 1.0 / math.sqrt(hd)
        impl = resolve_vit_attention(self.attention) if N > 1024 else "dense"
        if impl == "flash_sharded":
            out = sharded.flash_attention_sharded(qkv, scale, current_mesh(),
                                                  None if self.use_kernel else _plain_heads)
        elif impl == "flash":
            attend = kernels.flash_attention if self.use_kernel else kernels.flash_attention_plain
            out = attend(qkv, scale)
        elif impl == "chunked":
            out = chunked_attention(qkv, scale)
        else:
            q, k, v = qkv.unbind(2)
            logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
            w = torch.softmax(logits.float(), dim=-1).to(v.dtype)
            out = torch.einsum("bhnm,bmhd->bnhd", w, v)
        return self.proj(out.reshape(B, N, C))


class LayerScale(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return self.gamma.to(x.dtype) * x


class Mlp(nn.Module):
    def __init__(self, dim, hidden, cdt):
        super().__init__()
        self.fc1 = Linear(dim, hidden, cdt=cdt)
        self.fc2 = Linear(hidden, dim, cdt=cdt)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class Block(nn.Module):
    """Pre-norm block with LayerScale."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, attention="auto", use_kernel=True,
                 cdt=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, attention, use_kernel, cdt)
        self.ls1 = LayerScale(dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), cdt)
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


def interpolate_pos_embed(pos_embed: torch.Tensor, hp: int, wp: int,
                          offset: float = 0.1) -> torch.Tensor:
    """Bicubic pos-embed interpolation with the +offset scale factor:
    (1, 1 + M*M, C) -> (1, 1 + hp*wp, C)."""
    n = pos_embed.shape[1] - 1
    m = int(math.isqrt(n))
    if m * m != n:
        raise ValueError(f"{n} patch embeddings are not a square grid")
    if hp == m and wp == m:
        return pos_embed
    mh = torch.from_numpy(interp_matrix_np(m, hp, "cubic", False, float(hp + offset) / m))
    mw = torch.from_numpy(interp_matrix_np(m, wp, "cubic", False, float(wp + offset) / m))
    patch = pos_embed[:, 1:].reshape(1, m, m, -1).float()
    patch = torch.einsum("oh,bhwc->bowc", mh.to(patch.device), patch)
    patch = torch.einsum("ow,bhwc->bhoc", mw.to(patch.device), patch)
    return torch.cat([pos_embed[:, :1].float(), patch.reshape(1, hp * wp, -1)],
                     dim=1).to(pos_embed.dtype)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size, embed_dim, cdt):
        super().__init__()
        self.proj = Conv2d(3, embed_dim, patch_size, patch_size, cdt=cdt)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)             # (B, hp*wp, E)


class DinoVisionTransformer(nn.Module):
    """DINOv2 ViT forward with intermediate-layer taps; input (B, 3, H, W)
    with H and W divisible by the patch size."""

    def __init__(self, embed_dim, depth, num_heads, patch_size=14, pretrain_img_size=518,
                 mlp_ratio=4.0, attention="auto", use_kernel=True, cdt=torch.float32):
        super().__init__()
        self.patch_size = patch_size
        n_patches = (pretrain_img_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(patch_size, embed_dim, cdt)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patches + 1, embed_dim))
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, mlp_ratio, attention,
                                          use_kernel, cdt) for _ in range(depth))
        self.norm = LayerNorm(embed_dim)

    def forward(self, x, intermediate_layers):
        B, _, H, W = x.shape
        hp, wp = H // self.patch_size, W // self.patch_size
        tokens = self.patch_embed(x)
        cls = self.cls_token.to(tokens.dtype).expand(B, -1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
        tokens = tokens + interpolate_pos_embed(self.pos_embed, hp, wp).to(tokens.dtype)
        taps = {}
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens)
            if i in intermediate_layers:
                taps[i] = tokens
        outputs = []
        for i in intermediate_layers:
            t = self.norm(taps[i])
            outputs.append((t[:, 1:], t[:, 0]))                      # (patch tokens, cls)
        return outputs


def make_vit(vit_size: str, attention="auto", use_kernel=True, cdt=torch.float32):
    c = VIT_CONFIGS[vit_size]
    return DinoVisionTransformer(c["embed_dim"], c["depth"], c["num_heads"],
                                 attention=attention, use_kernel=use_kernel, cdt=cdt)
