"""The port's CUDA kernels against their plain twins, on a CUDA card.

Marked ``gpu``: without a card every test here skips. This file imports no
JAX, so it runs on the card's machine, which has none:

    python -m pytest tests/test_torch_gpu.py -q -o addopts="" --noconftest

Tolerances: fp32 outputs 1e-5 (summation order); bf16 outputs 2^-8, one
bf16 ulp at the largest magnitude (inputs in [-1, 1]); bf16 attention
against the fp32 twin: max error 2 bf16 ulps of max |ref|, mean error 1 bf16
ulp of mean |ref| (output rounding and bf16 probabilities in P @ V).
"""

from __future__ import annotations

import math

import pytest
import torch

from foundationstereo_torch.models.dinov2 import Attention
from foundationstereo_torch.ops import cost_volume, kernels, sampler

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _uniform(gen, *shape, device):
    return torch.rand(*shape, device=device, generator=gen) * 2 - 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cost_volume_kernel(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    l, r = (_uniform(g, 2, 64, 7, 90, device=cuda).to(dtype) for _ in range(2))
    rp = _uniform(g, 2, 12, 7, 90, device=cuda).to(dtype)
    kernels.reset_launches()
    gk, rk = kernels.cost_volume_parts(l, r, rp, 40, 8, out_dtype=dtype)
    gp, rpp = cost_volume.cost_volume_parts(l, r, rp, 40, 8, out_dtype=dtype)
    atol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(gk.float(), gp.float(), rtol=0, atol=atol)
    assert torch.equal(rk, rpp)
    assert kernels.LAUNCHES["cost_volume_parts"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lookup_kernel(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    b, h, w, c, d = 2, 5, 40, 7, 24
    geo = sampler.pool_last_axis(_uniform(g, b, h, w, c, d, device=cuda), 3)
    corr = sampler.pool_last_axis(_uniform(g, b, h, w, w, device=cuda), 3)
    geo = [x.to(dtype).contiguous() for x in geo]
    corr = [x.to(dtype).contiguous() for x in corr]
    disp = torch.rand(b, h, w, device=cuda, generator=g) * 3 * d - d
    disp[0, 0, :8] = torch.arange(8, device=cuda, dtype=torch.float32)
    disp[0, 1, :6] = torch.tensor([-100.0, 1e4, -0.5, d - 0.5, d - 1, -1.0], device=cuda)
    out = kernels.disparity_lookup(geo, corr, disp, 4, out_dtype=dtype)
    ref = sampler.disparity_lookup(geo, corr, disp, 4, out_dtype=dtype)
    atol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=atol)


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def test_flash_attention_kernel_ragged(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    qkv = torch.randn(2, 1100, 3, 3, 64, device=cuda, generator=g).bfloat16()
    out = kernels.flash_attention(qkv, 0.125)
    ref = kernels.flash_attention_plain(qkv.float(), 0.125)
    err = (out.float() - ref).abs()
    assert float(err.max()) <= 2 * _bf16_ulp(float(ref.abs().max()))
    assert float(err.mean()) <= _bf16_ulp(float(ref.abs().mean()))


def test_flash_attention_kernel_fp32(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(2, 1100, 3, 3, 64, device=cuda, generator=g)
    kernels.reset_launches()
    out = kernels.flash_attention(qkv, 0.125)
    assert out.dtype == torch.float32 and kernels.LAUNCHES["flash_attention"] == 1
    torch.testing.assert_close(out, kernels.flash_attention_plain(qkv, 0.125), rtol=0, atol=1e-5)


def test_vit_attention_fp32_config_runs_the_kernel(cuda):
    """Without mixed precision the ViT's attention over N > 1024 tokens runs
    the fp32 kernel on the card, not the dense twin."""
    torch.manual_seed(4)
    with torch.device(cuda):
        attn = Attention(192, 3, use_kernel=True)
        x = torch.randn(1, 1100, 192)
    plain = Attention(192, 3, use_kernel=False).to(cuda)
    plain.load_state_dict(attn.state_dict())
    kernels.reset_launches()
    with torch.no_grad():
        got, want = attn(x), plain(x)
    assert kernels.LAUNCHES["flash_attention"] == 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    qkv = torch.zeros(1, 70, 3, 2, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kernels.flash_attention(qkv, 0.125)                      # fp16
    with pytest.raises(ValueError, match="want"):
        kernels.flash_attention(torch.zeros(1, 70, 3, 2, 32, device=cuda).bfloat16(), 0.1)
    x = torch.zeros(1, 64, 4, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.cost_volume_parts(x.transpose(2, 3).contiguous().transpose(2, 3), x,
                                  torch.zeros(1, 12, 4, 16, device=cuda), 8, 8)
