"""The port's export (``foundationstereo_torch/inference/export.py``) and the
kernels as ``torch.library`` operators, on the CPU (~150 s serially, on one
torch thread: three exports of vits at 64x96, 2 iterations, each saved and
loaded back).

* A static (batch 1) and a dynamic-batch export, without and with the 3x3
  conv kernel routed (``pallas_conv3x3``), ``torch.export.save`` and
  ``load_exported``: the loaded program at batch 1 (and 2 where the batch
  is symbolic) equals the eager forward to 1e-6 (the operators' CPU kernels
  are the plain twins the eager forward runs).
* The exported graph holds the kernels as ``fs::`` operator nodes: one cost
  volume per pass, one lookup per iteration, one 3x3 conv per routed call,
  the counts of the eager forward's calls (counted as
  ``tests/test_torch_forward.py:_count_calls`` does).
* The manifest has the JAX package's keys and values.
* ``PackedWeights`` builds the derived weight without its cache while
  ``torch.export`` traces, and caches it in eager mode.
* The operators' shape functions give the outputs' shapes with a symbolic
  batch, and each operator refuses a tensor that needs a backward.
"""

from __future__ import annotations

import json
from collections import Counter

import numpy as np
import pytest
import torch

from foundationstereo_torch.config import ModelConfig
from foundationstereo_torch.inference.export import export_program, load_exported
from foundationstereo_torch.models.foundation_stereo import FoundationStereo
from foundationstereo_torch.models.layers import PackedWeights
from foundationstereo_torch.ops import kernels
from foundationstereo_torch.scripts import make_export
from test_torch_forward import _count_calls

CFG = ModelConfig(max_disp=64, vit_size="vits", mixed_precision=False, bf16_pyramids=False)
H, W, ITERS = 64, 96, 2
OPS = ("cost_volume_parts", "disparity_lookup", "flash_attention", "conv3x3")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread for this file: its tensors are small, and the
    suite runs several files at once, where a thread pool per process
    oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(batch, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.uniform(0, 255, (batch, H, W, 3)).astype(np.float32))
                 for _ in range(2))


def _graph_ops(program) -> Counter:
    return Counter(str(n.target).split(".")[1] for n in program.graph.nodes
                   if str(n.target).startswith("fs."))


@pytest.fixture(scope="module", params=[("static", False), ("dynamic", False), ("dynamic", True)],
                ids=["static", "dynamic", "dynamic-conv3x3"])
def exported(request, tmp_path_factory):
    """(model, loaded program, manifest, graph's fs:: nodes, batches run)."""
    kind, k4 = request.param
    model = FoundationStereo(CFG.replace(pallas_conv3x3=k4), device="cpu", seed=0)
    path = tmp_path_factory.mktemp("export") / "model.pt2"
    manifest = export_program(model, H, W, ITERS, path, dynamic_batch=kind == "dynamic")
    assert json.loads(path.with_name("model.pt2.json").read_text()) == manifest
    program = load_exported(path)
    return model, program, manifest, _graph_ops(program), (1, 2) if kind == "dynamic" else (1,)


def test_loaded_program_equals_eager(exported):
    model, program, _, _, batches = exported
    for b in batches:
        left, right = _pair(b, b)
        with torch.no_grad():
            want = model(left, right, iters=ITERS, test_mode=True)
        got = program(left, right)
        assert got.shape == want.shape == (b, H, W)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_graph_holds_the_eager_calls(exported, monkeypatch):
    model, _, _, ops, _ = exported
    calls = _count_calls(monkeypatch, kernels, list(OPS))
    with torch.no_grad():
        model(*_pair(1, 0), iters=ITERS, test_mode=True)
    assert calls["cost_volume_parts"] == 1 and calls["disparity_lookup"] == ITERS
    assert (calls["conv3x3"] > 0) == model.cfg.pallas_conv3x3
    assert ops == Counter({k: v for k, v in calls.items() if v})


def test_manifest_has_the_jax_keys(exported):
    _, _, manifest, _, batches = exported
    bdim = "b (symbolic)" if len(batches) == 2 else 1
    assert manifest["input_shapes"] == {"left": [bdim, H, W, 3], "right": [bdim, H, W, 3]}
    assert manifest["output"] == f"disparity ({bdim}, {H}, {W})"
    assert manifest["iters"] == ITERS and "torch.export" in manifest["format"]


def test_packed_weights_under_tracing():
    class Scaled(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.arange(4.0))
            self.cache = PackedWeights()

        def forward(self, x):
            return x * self.cache([self.w], [x.dtype], lambda: self.w * 2)

    m = Scaled()
    with torch.no_grad():
        program = torch.export.export(m, (torch.ones(4),))
    assert m.cache.key is None, "the trace filled the cache"
    with torch.no_grad():
        torch.testing.assert_close(program.module()(torch.ones(4)), m.w * 2)
        m(torch.ones(4))
    assert m.cache.key is not None
    with torch.no_grad():
        m.w.add_(1.0)             # a new version of the parameter makes the weight again
        torch.testing.assert_close(m(torch.ones(4)), m.w * 2)


def test_shape_functions_keep_the_batch_symbolic():
    rng = np.random.default_rng(0)

    class Calls(torch.nn.Module):
        def forward(self, feat, proj, disp, qkv, x, w):
            gwc, rps = kernels.cost_volume_parts(feat, feat, proj, 6, 4, torch.bfloat16)
            halo = kernels.cost_volume_parts_haloed(feat[..., 4:], feat, proj, 6, 4, 4)[0]
            geo = [gwc.float().permute(0, 3, 4, 1, 2).contiguous()]
            corr = [feat.new_zeros(feat.shape[0], feat.shape[2], feat.shape[3], 8)]
            lk = kernels.disparity_lookup(geo, corr, disp, 1)
            shard = kernels.disparity_lookup_shard(geo, corr, disp, 1, 0, torch.bfloat16)
            att = kernels.flash_attention(qkv, 0.125)
            heads = kernels.flash_attention_heads(qkv, 0.125, 1, 1)
            return gwc, rps, halo, lk, shard, att, heads, kernels.conv3x3(x, w)

    args = [rng.standard_normal(s).astype(np.float32) for s in
            [(2, 8, 3, 10), (2, 3, 3, 10), (2, 3, 10), (2, 9, 3, 2, 64), (2, 128, 3, 5),
             (64, 128, 3, 3)]]
    args = tuple(torch.from_numpy(a) for a in args)
    args[2].abs_()
    b = torch.export.Dim("b", min=1, max=64)
    shapes = ({0: b}, {0: b}, {0: b}, {0: b}, {0: b}, None)
    with torch.no_grad():
        program = torch.export.export(Calls(), args, dynamic_shapes=shapes)
        outs = Calls()(*args)
    fake = [n.meta["val"] for n in program.graph.output_node().args[0]]
    for got, want in zip(fake, outs):
        assert isinstance(got.shape[0], torch.SymInt)
        assert tuple(got.shape[1:]) == tuple(want.shape[1:]) and got.dtype == want.dtype
        assert want.is_contiguous()
    with pytest.raises(ValueError, match="no backward"):
        kernels.conv3x3(args[4].requires_grad_(), args[5])


def test_make_export_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_export.main(["--save_path", str(tmp_path / "m.pt2")])
