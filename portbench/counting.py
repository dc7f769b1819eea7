"""The yardstick's arithmetic: the card's peaks, a kernel's least time, the
ViT attention's operations and bytes, the 3x3 convolutions' operations, and
the model's FLOPs counted from the reference's own operations.

Frozen here so that a change to the program cannot change what it is
measured against.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BPS = 3.35e12


def bound_s(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time of a kernel: the larger of its bytes at the HBM peak and
    its operations at the tensor cores' peak."""
    return max(nbytes / PEAK_HBM_BPS, flops / peak_flops)


def vit_tokens(height: int, width: int) -> int:
    """Patch tokens plus the class token of the ViT's input: the image
    resized to multiples of 112 (at most 1344 on the longer side), patches of 14."""
    from portbench.reference.ops import resize_keep_aspect

    h, w = resize_keep_aspect(height, width, 112, 1344, 1344)
    return (h // 14) * (w // 14) + 1


def attention_flops(images: int, heads: int, tokens: int, head_dim: int) -> float:
    """softmax(q k^T) v: two products of N x N x d per image and head."""
    return 4.0 * images * heads * tokens * tokens * head_dim


def attention_bytes(images: int, heads: int, tokens: int, head_dim: int, itemsize: int = 2) -> float:
    """q, k and v read once and the output written once."""
    return 4.0 * images * tokens * heads * head_dim * itemsize


def attention_bound_s(images: int, heads: int, tokens: int, head_dim: int) -> float:
    return bound_s(attention_bytes(images, heads, tokens, head_dim),
                   attention_flops(images, heads, tokens, head_dim))


def _k4_eligible(m) -> bool:
    """The 3x3 conv kernel's rule: 3x3 spatial taps, stride 1, padding 1, no
    dilation, no groups, C >= 128 and F >= 64."""
    ks, st, pd, dl = m.kernel_size[-2:], m.stride[-2:], m.padding[-2:], m.dilation[-2:]
    if not (tuple(ks) == (3, 3) and tuple(st) == (1, 1) and tuple(pd) == (1, 1)
            and tuple(dl) == (1, 1) and m.groups == 1
            and m.in_channels >= 128 and m.out_channels >= 64):
        return False
    if isinstance(m, torch.nn.Conv3d):      # (1, 3, 3) folded over D, or taps along D
        return m.kernel_size[0] > 1 or (m.stride[0] == 1 and m.padding[0] == 0)
    return isinstance(m, torch.nn.Conv2d)


def meta_model(cfg: dict):
    """The reference model on the meta device (shapes only, no memory)."""
    from portbench.reference.model import FoundationStereo

    with torch.device("meta"):
        return FoundationStereo(cfg).eval()


def k4_conv_flops(cfg: dict, height: int, width: int, iters: int, batch: int = 1) -> float:
    """Operations of the convolutions the 3x3 conv kernel would take over one
    test-mode forward: 2 C F 9 per output point (per depth tap of a 3D conv)."""
    model = meta_model(cfg)
    total = [0.0]

    def hook(m, _args, out):
        taps = m.kernel_size[0] if isinstance(m, torch.nn.Conv3d) else 1
        total[0] += 2.0 * m.in_channels * m.out_channels * 9 * taps * out.numel() / m.out_channels

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d)) and _k4_eligible(m)]
    x = torch.empty((batch, height, width, 3), device="meta")
    with torch.no_grad():
        model(x, x, iters, test_mode=True)
    for h in handles:
        h.remove()
    return total[0]


def forward_flops(cfg: dict, height: int, width: int, iters: int, batch: int) -> float:
    """Matrix-unit FLOPs (convolutions, matrix products, attention) of one
    test-mode forward of the reference, by ``torch.utils.flop_counter``."""
    from torch.utils.flop_counter import FlopCounterMode

    model = meta_model(cfg)
    x = torch.empty((batch, height, width, 3), device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(x, x, iters, test_mode=True)
    return float(counter.get_total_flops())


def train_step_flops(recipe: dict, height: int, width: int, batch: int) -> float:
    """FLOPs of one training step of the reference: the train-mode forward
    (``train_iters`` refinement steps) and its backward, without recompute."""
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference.train import composite_loss

    cfg = recipe["model"]
    model = meta_model(cfg)
    model.eval()   # dropout and batch statistics are elementwise: no FLOPs either way
    for p in model.feature.dino.parameters():
        p.requires_grad_(False)
    x = torch.empty((batch, height, width, 3), device="meta")
    gt = torch.empty((batch, height, width), device="meta")
    mask = torch.empty((batch, height, width), dtype=torch.bool, device="meta")
    label = torch.empty((batch,), dtype=torch.long, device="meta")
    with FlopCounterMode(display=False) as counter:
        init_disp, preds = model(x, x, cfg["train_iters"], test_mode=False)
        loss = composite_loss(recipe["loss"], init_disp, preds, gt, mask, label)
        loss.backward()
    return float(counter.get_total_flops())
