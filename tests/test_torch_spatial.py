"""Width partitioning over a spatial mesh of ranks (``parallel/spatial.py``)
on the CPU: ``gloo`` ranks in spawned processes against one process.

* Each W-coupled primitive on 2 ranks and on 3 (a data 1 x spatial 3 mesh:
  uneven shards) against the unpartitioned op in one process, forward and
  gradient (the input's, and the parameters' summed over the ranks), fp32:
  max abs <= 1e-5 x max(1, max |ref|). The image is 224 wide: 7 units of 32
  columns, 3/4 on 2 ranks and 2/2/3 on 3, so every level's shards are
  uneven. A conv one column wide along W exchanges nothing.
* The filter stack (CorrStem -> FeatureAtt -> Hourglass -> Classifier) at
  the JAX package's ``__graft_entry__._filter_shard_check`` shape (B 1, D 16,
  H 16, W 64, volume_dim 28, max_disp 64) on 2 ranks against the JAX
  single-device stack with bridged weights: max abs <= 1e-4 (JAX's own check
  allows its sharded filter 1e-3 against single device).
* The whole forward (vits, fp32, 64x128, 2 iterations, random JAX weights
  bridged) on 2 ranks: the gathered disparity against the JAX single-device
  forward within 1e-2 px (the whole-forward bound of
  ``test_torch_forward.py``) and against the port's unpartitioned forward
  within 1e-4 px; every rank launches one cost-volume build and one lookup
  per iteration through the per-rank (K5) wrappers, and no K1, K2 or K4.
* One ``Trainer.train_step`` on spatial 2 at batch 1 and on data 2 x
  spatial 2 at batch 2 against one process on the same batch (the
  data-parallel step test's bounds and reasons, ``test_torch_distributed.py``): |dg| / |g|
  within 5e-2 over all gradients and 1e-1 per tensor, the gradient norm
  within 1e-2, the running stats and the EMA within 1e-6, every rank's
  parameters, stats and EMA bit for bit rank 0's. The loss within 2e-6
  relative: the one-process step against itself on 1, 2 and 4 torch
  threads moves it by up to 4.7e-7, and the partitioned forward's own
  summation order adds as much (measured: 5.5e-7 and 8.0e-7).
* The train CLI with ``--device cpu --n_devices 2 --batch_size 1`` (spatial
  2, as the JAX CLI's ``make_mesh(2)``): 2 steps and a resume.
* The ViT attention over the ranks (``vit_attention="auto"``, N 1025 > the
  dense cut-off, dim 128, 4 heads, fp32): on 2 ranks each attends over its
  2 heads and one heads gather gives every rank all 4; on 3 (4 % 3 != 0)
  each attends over all 4 with no collective. Against the JAX package's
  ``flash_vit_attention_sharded`` on a (1, 2) and a (1, 3) CPU mesh (its
  flash kernel has no CPU path: ``chunked_attention`` per shard, as
  ``test_torch_parallel.py`` runs it), the module's projection applied to
  both: ``test_torch_parallel.py``'s tolerance; against the port in one
  process within 1e-6. The gather's backward, with the partial cotangents
  the replicated region holds (rank s: the tokens t with t % S == s): the
  gradient w.r.t. qkv, summed over the ranks, against one process's within
  1e-6.

Ranks meet through a ``file://`` rendezvous in a temporary directory and run
torch on one thread. JAX is imported inside the fixtures only: every
spawned rank imports this file again.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from foundationstereo_torch.config import ModelConfig
from foundationstereo_torch.models import layers
from foundationstereo_torch.models.cost_filter import Classifier, CorrStem, Hourglass
from foundationstereo_torch.models.dinov2 import Attention, _plain_heads, resolve_vit_attention
from foundationstereo_torch.models.foundation_stereo import FoundationStereo, kernel_mode
from foundationstereo_torch.models.update import RaftConvGRU, interp
from foundationstereo_torch.ops import kernels, sharded
from foundationstereo_torch.ops.resize import resize_dhw
from foundationstereo_torch.ops.upsample import avg_pool2x, context_upsample
from foundationstereo_torch.parallel import distributed, make_mesh, mesh_context, spatial
from foundationstereo_torch.parallel.mesh import RankMesh
from foundationstereo_torch.train import cli
from test_torch_distributed import _cli_args, _global_batch, _one_step, _write_dataset

CFG = ModelConfig(max_disp=64, vit_size="vits", mixed_precision=False, bf16_pyramids=False)
FWD_HW, FWD_ITERS = (64, 128), 2
FILTER = dict(b=1, d=16, h=16, w=64, chans=(48, 64, 96, 128))
IMAGE_W = 224                       # the primitives' image: 7 units of 32 columns
ATTN = dict(n=1025, dim=128, heads=4)   # N above the ViT's 1024-token dense cut-off


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rank_entry(rank: int, fn, world: int, url: str, args: tuple) -> None:
    torch.set_num_threads(1)
    distributed.initialize(url, world, rank, backend="gloo")
    try:
        fn(rank, *args)
    finally:
        torch.distributed.destroy_process_group()


def _spawn(fn, world: int, tmp: Path, *args):
    url = (tmp / f"rendezvous{world}").absolute().as_uri()
    return mp.spawn(_rank_entry, args=(fn, world, url, args), nprocs=world, join=False)


def _join(ctx) -> None:
    while not ctx.join(timeout=300):
        pass


def _close(got, want, rel: float, what: str) -> None:
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert err <= rel * max(1.0, float(want.abs().max())), (what, err)


# ---------------------------------------------------------------------------
# the primitives
# ---------------------------------------------------------------------------

def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _seeded(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Parameters N(0, 1/fan) from ``seed``, the same in every process."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) / max(1.0, p[0].numel() ** 0.5))
    return module


def _case(name: str):
    """(fn, inputs, module): the op and its inputs at their global shapes
    (W last; the levels of a 224-wide image)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    m = None
    if name == "conv2d_3x3":
        m = _seeded(layers.Conv2d(4, 5, 3, 1, 1), 1)
        xs = [_rand(rng, 1, 4, 6, 56)]
    elif name == "conv2d_7x7_depthwise":
        m = _seeded(layers.Conv2d(4, 4, 7, 1, 3, groups=4), 2)
        xs = [_rand(rng, 1, 4, 6, 56)]
    elif name == "conv3d_3x3x3":
        m = _seeded(layers.Conv3d(3, 4, 3, 1, 1), 3)
        xs = [_rand(rng, 1, 3, 4, 5, 28)]
    elif name == "conv3d_stride2":
        m = _seeded(layers.Conv3d(3, 4, 3, 2, 1), 4)
        xs = [_rand(rng, 1, 3, 4, 6, 14)]
    elif name == "conv3d_patch_k4s4":
        m = _seeded(layers.Conv3d(4, 4, 4, 4, 0, groups=4), 5)
        xs = [_rand(rng, 1, 4, 8, 8, 56)]
    elif name == "conv3d_disparity_17x1x1":
        m = _seeded(layers.Conv3d(3, 3, (17, 1, 1), 1, (8, 0, 0)), 6)
        xs = [_rand(rng, 1, 3, 6, 4, 28)]
    elif name == "deconv2d_k4s2p1":
        m = _seeded(layers.ConvTranspose2d(4, 3, 4, 2, 1), 7)
        xs = [_rand(rng, 1, 4, 5, 56)]
    elif name == "deconv3d_k4s2p1":
        m = _seeded(layers.ConvTranspose3d(4, 3, 4, 2, 1), 8)
        xs = [_rand(rng, 1, 4, 3, 4, 7)]
    elif name == "conv2x_match_hw":
        m = _seeded(layers.Conv2x(4, 4, bn=False), 9)
        xs = [_rand(rng, 1, 4, 5, 56), _rand(rng, 1, 4, 10, 112)]
    elif name == "gru_fused_zr":
        m = _seeded(RaftConvGRU(4, 4, 3), 10)
        xs = [_rand(rng, 1, 4, 5, 28), _rand(rng, 1, 4, 5, 28), _rand(rng, 1, 8, 5, 28)]
    elif name == "interp_align_corners":
        return (lambda x, dest: interp(x, dest)), [_rand(rng, 1, 3, 5, 14),
                                                   _rand(rng, 1, 1, 10, 28)], None
    elif name == "resize_dhw_x4":
        return (lambda x: resize_dhw(x, (8, 12, 4 * x.shape[-1]), "trilinear")), \
            [_rand(rng, 1, 3, 2, 3, 14)], None
    elif name == "avg_pool2x":
        return avg_pool2x, [_rand(rng, 1, 3, 6, 28)], None
    elif name == "context_upsample":
        return context_upsample, [_rand(rng, 1, 6, 56),
                                  torch.softmax(_rand(rng, 1, 9, 24, 224), dim=1)], None
    elif name == "batch_norm_train":
        m = _seeded(layers.BatchNorm(3), 11).train()
        xs = [_rand(rng, 2, 3, 4, 5, 28) * 2 + 0.5]
    elif name == "disparity_transformer_train":
        m = _seeded(layers.CostVolumeDisparityAttention(8, 4, 8, 2, max_len=4), 12).train()
        xs = [_rand(rng, 1, 8, 4, 3, 14)]
    else:
        raise KeyError(name)
    return m, xs, m


PRIMITIVES = ["conv2d_3x3", "conv2d_7x7_depthwise", "conv3d_3x3x3", "conv3d_stride2",
              "conv3d_patch_k4s4", "conv3d_disparity_17x1x1", "deconv2d_k4s2p1",
              "deconv3d_k4s2p1", "conv2x_match_hw", "gru_fused_zr", "interp_align_corners",
              "resize_dhw_x4", "avg_pool2x", "context_upsample", "batch_norm_train",
              "disparity_transformer_train"]


# Ops that read nothing across a shard border: one column wide along W, a
# stride that equals the kernel on aligned borders, per-pixel or per-channel.
NO_HALO = {"conv3d_disparity_17x1x1", "conv3d_patch_k4s4", "batch_norm_train",
           "disparity_transformer_train"}


def _run_primitive(name: str, part: spatial.Partition | None) -> dict:
    """The op's output and gradients (a seeded cotangent on the whole
    output): on ``part``'s columns, gathered, or whole without one."""
    fn, xs, module = _case(name)
    if part is not None:
        xs = [part.take(x) for x in xs]
    xs = [x.contiguous().requires_grad_() for x in xs]
    spatial.reset_exchanges()
    gen = torch.Generator().manual_seed(7)
    with spatial.region(part), layers.dropout_generator(gen):
        y = fn(*xs)
    exchanges = dict(spatial.EXCHANGES)
    whole = y if part is None else part.gather(y)
    cot = torch.randn(whole.shape, generator=torch.Generator().manual_seed(3))
    (whole * cot).sum().backward()
    with torch.no_grad():
        dx = [x.grad if part is None or x.grad is None else part.gather(x.grad) for x in xs]
        dp = {} if module is None else {k: p.grad.clone() for k, p in module.named_parameters()}
        if part is not None:
            for g in dp.values():
                torch.distributed.all_reduce(g)
        stats = {} if module is None else {k: b.clone() for k, b in module.named_buffers()}
    return {"y": whole.detach(), "dx": dx, "dp": dp, "stats": stats, "exchanges": exchanges}


def _primitives_rank(rank: int, world: int, out: Path) -> None:
    mesh = make_mesh(shape=(1, world))
    part = spatial.Partition(mesh, IMAGE_W)
    res = {name: _run_primitive(name, part) for name in PRIMITIVES}
    if rank == 0:
        torch.save(res, out / f"primitives{world}.pt")


# ---------------------------------------------------------------------------
# the ViT attention over the ranks
# ---------------------------------------------------------------------------

def _attention_case():
    """(module, x, qkv, cotangent): the seeded Attention (vit_attention
    "auto", its kernel wrappers), its input, and a qkv and cotangent for the
    gather's backward."""
    rng = np.random.default_rng(5)
    n, dim, heads = ATTN["n"], ATTN["dim"], ATTN["heads"]
    attn = _seeded(Attention(dim, heads), 13)
    x = _rand(rng, 1, n, dim)
    qkv = _rand(rng, 1, n, 3, heads, dim // heads)
    return attn, x, qkv, _rand(rng, 1, n, heads, dim // heads)


def _attention_rank(mesh) -> dict:
    """The Attention module's output under ``mesh``, the attention wrappers'
    calls ((h0, n_heads) per head shard, "whole" per K3 call) and the
    collectives it issued; and the gradient w.r.t. qkv, through
    ``flash_attention_sharded`` with the differentiable twin, of this
    rank's part of (out * cot).sum(): the tokens t with t % S == s, as the
    replicated region's cotangents differ per rank."""
    attn, x, qkv, cot = _attention_case()
    calls = []
    heads, whole = kernels.flash_attention_heads, kernels.flash_attention
    kernels.flash_attention_heads = lambda q, s, h0, n: calls.append((h0, n)) or heads(q, s, h0, n)
    kernels.flash_attention = lambda q, s: calls.append("whole") or whole(q, s)
    spatial.reset_exchanges()
    try:
        with mesh_context(mesh), torch.no_grad():
            y = attn(x)
    finally:
        kernels.flash_attention_heads, kernels.flash_attention = heads, whole
    exchanges = dict(spatial.EXCHANGES)
    qkv.requires_grad_()
    out = sharded.flash_attention_sharded(qkv, 0.125, mesh, _plain_heads)
    n_spatial, s = mesh.shape["spatial"], mesh.spatial_index
    (out * cot)[:, s::n_spatial].sum().backward()
    return {"y": y, "calls": calls, "exchanges": exchanges, "dqkv": qkv.grad,
            "heads_backward": spatial.EXCHANGES["heads_backward"]}


def _attention_refs(n_spatial: int) -> dict:
    """In this process: the port's Attention with no mesh, the JAX package's
    ``flash_vit_attention_sharded`` on a (1, ``n_spatial``) CPU mesh with the
    module's qkv and projection, and the one-process qkv gradient."""
    import jax.numpy as jnp

    from foundationstereo_tpu.models.dinov2 import chunked_attention, flash_vit_attention_sharded
    from foundationstereo_tpu.parallel.mesh import make_mesh as jax_make_mesh

    attn, x, qkv, cot = _attention_case()
    b, n, dim = x.shape
    heads = ATTN["heads"]
    with torch.no_grad():
        one = attn(x)
        q, k, v = (jnp.asarray(t.numpy()) for t in
                   attn.qkv(x).reshape(b, n, 3, heads, dim // heads).unbind(2))
        jout = flash_vit_attention_sharded(q, k, v, (dim // heads) ** -0.5,
                                           jax_make_mesh(n_spatial, shape=(1, n_spatial)),
                                           attn_fn=chunked_attention)
        jax_y = attn.proj(torch.from_numpy(np.array(jout)).reshape(b, n, dim))
    qkv.requires_grad_()
    (_plain_heads(qkv, 0.125, 0, heads) * cot).sum().backward()
    return {"one": one, "jax": jax_y, "dqkv": qkv.grad}


# ---------------------------------------------------------------------------
# the filter stack and the whole forward, on 2 ranks
# ---------------------------------------------------------------------------

class _Filter(torch.nn.Module):
    """``__graft_entry__._filter_shard_check``'s stack, under the full model's
    module names (so the bridge maps the JAX stack's variables)."""

    def __init__(self):
        super().__init__()
        self.corr_stem = CorrStem(32, 28)
        self.corr_feature_att = layers.FeatureAtt(28, FILTER["chans"][0])
        self.cost_agg = Hourglass(28, 64, FILTER["chans"])
        self.classifier = Classifier(28)

    def forward(self, vol, feats):
        y = self.corr_feature_att(self.corr_stem(vol), feats[0])
        return self.classifier(self.cost_agg(y, feats))


def _filter_inputs():
    f = FILTER
    rng = np.random.default_rng(2)
    vol = rng.standard_normal((f["b"], f["d"], f["h"], f["w"], 32)).astype(np.float32)
    feats = [rng.standard_normal((f["b"], f["h"] >> i, f["w"] >> i, c)).astype(np.float32)
             for i, c in enumerate(f["chans"])]
    return vol, feats


def _fwd_inputs():
    rng = np.random.default_rng(0)
    return [rng.uniform(0, 255, (1,) + FWD_HW + (3,)).astype(np.float32) for _ in range(2)]


def _two_rank_work(rank: int, out: Path) -> None:
    """Rank 0 of 2 keeps: the primitives, the filter stack's and the
    forward's gathered outputs, the forward's kernel calls, and the spatial-2
    train step at batch 1 (rank 1 its checksums); both keep the attention's."""
    _primitives_rank(rank, 2, out)
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "spatial": 2}
    res = {"attention": _attention_rank(mesh)}
    flt = _Filter().eval()
    flt.load_state_dict(torch.load(out / "filter_weights.pt"))
    vol, feats = _filter_inputs()
    part = spatial.Partition(mesh, 4 * FILTER["w"])
    vol = part.take(torch.from_numpy(vol).permute(0, 4, 1, 2, 3))
    feats = [part.take(torch.from_numpy(f).permute(0, 3, 1, 2)) for f in feats]
    with torch.no_grad(), spatial.region(part):
        res["filter"] = part.gather(flt(vol, feats))

    model = FoundationStereo(CFG, device="cpu")
    model.load_state_dict(torch.load(out / "model_weights.pt"))
    calls = {k: 0 for k in kernels.LAUNCHES}
    wrapped = {}
    for name in calls:
        fn = getattr(kernels, name)

        def count(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        wrapped[name] = fn
        setattr(kernels, name, count)
    try:
        with mesh_context(mesh), torch.no_grad():
            res["forward"] = model(*map(torch.from_numpy, _fwd_inputs()), iters=FWD_ITERS,
                                   test_mode=True)
    finally:
        for name, fn in wrapped.items():
            setattr(kernels, name, fn)
    res["calls"] = calls
    del model
    with mesh_context(mesh):
        step = _one_step(distributed.local_slice(_global_batch(1), mesh))[0]
    res["step"] = step if rank == 0 else {"checksums": step["checksums"]}
    torch.save(res, out / f"two{rank}.pt")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """2 ranks do their work while this process computes the references: the
    JAX filter stack and forward, the port's unpartitioned forward and the
    one-process step at batch 1."""
    import jax

    from foundationstereo_torch.convert.from_jax import flatten_variables, jax_to_state_dict
    from foundationstereo_tpu.models.cost_filter import Classifier as JClassifier
    from foundationstereo_tpu.models.cost_filter import CorrStem as JCorrStem
    from foundationstereo_tpu.models.cost_filter import Hourglass as JHourglass
    from foundationstereo_tpu.models.foundation_stereo import FoundationStereo as JaxModel
    from foundationstereo_tpu.models.layers import FeatureAtt as JFeatureAtt
    from test_torch_modules import JCFG, random_variables

    import flax.linen as nn

    class JFilter(nn.Module):
        @nn.compact
        def __call__(self, vol, feats):
            y = JCorrStem(28, name="corr_stem")(vol)
            y = JFeatureAtt(28, name="corr_feature_att")(y, feats[0])
            y = JHourglass(28, max_disp=64, name="cost_agg")(y, feats)
            return JClassifier(28, name="classifier")(y)

    out = tmp_path_factory.mktemp("spatial")
    vol, feats = _filter_inputs()
    jf = JFilter()
    vf = random_variables(jf, vol, feats, seed=4)
    sd, unmapped = jax_to_state_dict(flatten_variables(vf), CFG)
    assert not unmapped
    torch.save(sd, out / "filter_weights.pt")
    left, right = _fwd_inputs()
    jm = JaxModel(JCFG)
    vm = random_variables(jm, left, right, iters=1, test_mode=True)
    sd, unmapped = jax_to_state_dict(flatten_variables(vm), CFG)
    assert not unmapped
    torch.save(sd, out / "model_weights.pt")

    ctx = _spawn(_two_rank_work, 2, out, out)
    ref = {"jax_filter": np.asarray(jax.jit(jf.apply)(vf, vol, feats)),
           "jax_forward": np.asarray(jax.jit(lambda v, a, b: jm.apply(
               v, a, b, iters=FWD_ITERS, test_mode=True))(vm, left, right))}
    model = FoundationStereo(CFG, device="cpu")
    model.load_state_dict(sd)
    with torch.no_grad():
        ref["forward"] = model(torch.from_numpy(left), torch.from_numpy(right), iters=FWD_ITERS,
                               test_mode=True)
    del model
    ref["primitives"] = {name: _run_primitive(name, None) for name in PRIMITIVES}
    ref["attention"] = _attention_refs(2)
    ref["step"] = _one_step(_global_batch(1))[0]
    _join(ctx)
    got = [torch.load(out / f"two{r}.pt") for r in range(2)]
    got[0]["primitives"] = torch.load(out / "primitives2.pt")
    for p in out.glob("*.pt"):
        p.unlink()                      # the suite shares one disk
    return got, ref


def _three_rank_work(rank: int, out: Path) -> None:
    """The primitives on 3 ranks, and every rank's attention, on a data 1 x
    spatial 3 mesh."""
    _primitives_rank(rank, 3, out)
    mesh = make_mesh(shape=(1, 3))
    assert mesh.spatial_index == rank
    torch.save(_attention_rank(mesh), out / f"attention3_{rank}.pt")


@pytest.fixture(scope="module")
def three_ranks(tmp_path_factory):
    """Rank 0's primitives, every rank's attention, and its references."""
    out = tmp_path_factory.mktemp("spatial3")
    ctx = _spawn(_three_rank_work, 3, out, out)
    ref = _attention_refs(3)
    _join(ctx)
    return {"primitives": torch.load(out / "primitives3.pt"),
            "attention": [torch.load(out / f"attention3_{r}.pt") for r in range(3)],
            "attention_ref": ref}


def _check_primitive(got: dict, want: dict, name: str) -> None:
    _close(got["y"], want["y"], 1e-5, f"{name} output")
    for i, (a, b) in enumerate(zip(got["dx"], want["dx"])):
        assert (a is None) == (b is None), (name, i)
        if b is not None:                       # None: an input read for its shape only
            _close(a, b, 1e-5, f"{name} input {i} gradient")
    assert set(got["dp"]) == set(want["dp"])
    for k in want["dp"]:
        _close(got["dp"][k], want["dp"][k], 1e-5, f"{name} {k} gradient")
    for k in want["stats"]:
        _close(got["stats"][k], want["stats"][k], 1e-5, f"{name} {k}")
    if name in NO_HALO:
        assert got["exchanges"]["halo"] == 0
    else:
        assert got["exchanges"]["halo"] > 0


@pytest.mark.parametrize("name", PRIMITIVES)
def test_primitive_on_two_ranks(two_ranks, name):
    got, ref = two_ranks
    _check_primitive(got[0]["primitives"][name], ref["primitives"][name], name)


@pytest.mark.parametrize("name", PRIMITIVES)
def test_primitive_on_three_uneven_ranks(two_ranks, three_ranks, name):
    _check_primitive(three_ranks["primitives"][name], two_ranks[1]["primitives"][name], name)


def _check_attention(got: dict, ref: dict) -> None:
    np.testing.assert_allclose(got["y"].numpy(), ref["jax"].numpy(), rtol=1e-5, atol=1e-5)
    _close(got["y"], ref["one"], 1e-6, "attention against one process")


def test_attention_on_two_ranks_takes_its_heads_and_matches_jax(two_ranks):
    """Rank s attends over the heads [2 s, 2 s + 2) once, one heads gather
    gives it all 4, and the output is JAX's sharded attention's."""
    got, ref = two_ranks
    for rank, g in enumerate(got):
        att = g["attention"]
        assert att["calls"] == [(2 * rank, 2)], att["calls"]
        assert att["exchanges"]["heads"] == 1
        assert att["exchanges"]["heads_bytes"] == 4 * ATTN["n"] * ATTN["dim"]   # fp32 over gloo
        assert att["exchanges"]["halo"] == att["exchanges"]["gather"] == 0
        assert att["exchanges"]["bytes"] == 0                # the partition's alone
        _check_attention(att, ref["attention"])


def test_attention_gather_backward_on_two_ranks(two_ranks):
    """Each rank holds its part of the cotangent; the backward sums it over
    the ranks (one collective) and hands each its own heads: their qkv
    gradients sum to one process's."""
    got, ref = two_ranks
    total = sum(g["attention"]["dqkv"] for g in got)
    _close(total, ref["attention"]["dqkv"], 1e-6, "qkv gradient summed over the ranks")
    for rank, g in enumerate(got):
        assert g["attention"]["heads_backward"] == 1
        dq = g["attention"]["dqkv"]
        other = [h for h in range(ATTN["heads"]) if h // 2 != rank]
        assert not dq[:, :, :, other].any()


def test_attention_on_three_ranks_is_whole_and_matches_jax(three_ranks):
    """4 heads do not split over 3 ranks: each attends over all of them
    with K3's wrapper and issues no collective, as JAX's replicated axis."""
    for att in three_ranks["attention"]:
        assert att["calls"] == ["whole"], att["calls"]
        assert all(v == 0 for v in att["exchanges"].values()), att["exchanges"]
        _check_attention(att, three_ranks["attention_ref"])
        assert att["heads_backward"] == 0
    total = sum(att["dqkv"] for att in three_ranks["attention"])
    _close(total, three_ranks["attention_ref"]["dqkv"], 1e-6, "qkv gradient summed over the ranks")


def test_filter_stack_on_two_ranks_matches_jax(two_ranks):
    got, ref = two_ranks
    want = ref["jax_filter"]                                  # (B, D, H, W)
    assert tuple(got[0]["filter"].shape) == want.shape
    assert float(np.abs(got[0]["filter"].numpy() - want).max()) <= 1e-4


def test_forward_on_two_ranks_matches_jax(two_ranks):
    got, ref = two_ranks
    for g in got:
        assert tuple(g["forward"].shape) == ref["jax_forward"].shape == (1,) + FWD_HW
        assert float(np.abs(g["forward"].numpy() - ref["jax_forward"]).max()) <= 1e-2


def test_forward_on_two_ranks_matches_the_unpartitioned_forward(two_ranks):
    got, ref = two_ranks
    for g in got:
        assert float((g["forward"] - ref["forward"]).abs().max()) <= 1e-4
        assert g["calls"]["cost_volume_parts_haloed"] == 1
        assert g["calls"]["disparity_lookup_shard"] == FWD_ITERS
        assert g["calls"]["conv3d_1out"] == 1
        for name in ("cost_volume_parts", "disparity_lookup", "conv3x3", "flash_attention_heads"):
            assert g["calls"][name] == 0, name


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _check_step(got: dict, want: dict) -> None:
    m, w = got["metrics"], want["metrics"]
    assert m["skipped_nonfinite"] == w["skipped_nonfinite"] == 0.0
    assert abs(m["loss"] - w["loss"]) <= 2e-6 * abs(w["loss"]), (m["loss"], w["loss"])
    assert abs(m["grad_norm"] - w["grad_norm"]) <= 1e-2 * w["grad_norm"]
    assert set(got["grads"]) == set(want["grads"]) and len(want["grads"]) > 100
    total = torch.sqrt(sum((g.double() ** 2).sum() for g in want["grads"].values()))
    d_total = torch.sqrt(sum(((got["grads"][k] - g).double() ** 2).sum()
                             for k, g in want["grads"].items()))
    assert d_total <= 5e-2 * total, float(d_total / total)
    for k, g in want["grads"].items():
        dg = float((got["grads"][k] - g).norm())
        if g.norm() < 1e-5 * total:            # mathematically 0: a bias before a norm
            assert dg <= 1e-5 * float(total), (k, dg)
        else:
            assert dg <= 1e-1 * float(g.norm()), (k, dg / float(g.norm()))
    for part in ("buffers", "ema"):
        for k, v in want[part].items():
            torch.testing.assert_close(got[part][k], v, rtol=1e-6, atol=1e-6, msg=f"{part} {k}")


def test_train_step_on_spatial_two_is_the_one_process_step(two_ranks):
    got, ref = two_ranks
    assert torch.equal(got[1]["step"]["checksums"], got[0]["step"]["checksums"])
    _check_step(got[0]["step"], ref["step"])


def _step_rank(rank: int, out: Path) -> None:
    mesh = make_mesh(shape=(2, 2))
    with mesh_context(mesh):
        step = _one_step(distributed.local_slice(_global_batch(2), mesh))[0]
    torch.save(step if rank == 0 else {"checksums": step["checksums"]}, out / f"step{rank}.pt")


def test_train_step_on_data_two_by_spatial_two_is_the_one_process_step(tmp_path):
    ctx = _spawn(_step_rank, 4, tmp_path, tmp_path)
    want = _one_step(_global_batch(2))[0]
    _join(ctx)
    got = [torch.load(tmp_path / f"step{r}.pt") for r in range(4)]
    for r in range(4):
        (tmp_path / f"step{r}.pt").unlink()
        assert torch.equal(got[r]["checksums"], got[0]["checksums"]), r
    _check_step(got[0], want)


# ---------------------------------------------------------------------------
# the train CLI, the partition's rules
# ---------------------------------------------------------------------------

def test_train_cli_spatial_two_at_batch_one(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    data = _write_dataset(tmp_path / "data", 2)
    ws = tmp_path / "ws"
    extra = ("--n_devices", "2", "--batch_size", "1")
    line = cli.main(_cli_args(tmp_path, data, 2, "none", *extra))
    assert line["step"] == 1 and np.isfinite(line["loss"])
    line = cli.main(_cli_args(tmp_path, data, 3, "latest", *extra))
    assert line["step"] == 2 and np.isfinite(line["loss"])
    lines = [json.loads(x) for x in (ws / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [0, 1, 2]
    for x in lines:
        assert np.isfinite(x["grad_norm"]) and x["skipped_nonfinite"] == 0.0
    assert torch.load(ws / "checkpoints" / "latest.pt")["step"] == 3
    for p in (ws / "checkpoints").iterdir():
        p.unlink()                      # the suite shares one disk


def test_partition_columns_by_units_of_32():
    """Rank k takes units [k U / S, (k + 1) U / S) of the W / 32: the train
    crops (W 320) over 4 ranks give 16/24/16/24 columns at 1/4."""
    class FakeMesh(RankMesh):
        def __init__(self, n, k):
            self.shape, self.spatial_index = {"data": 1, "spatial": n}, k

    part = spatial.Partition(FakeMesh(4, 1), 320)
    assert part.widths(80) == [16, 24, 16, 24]
    assert [part.columns(80, k) for k in range(4)] == [(0, 16), (16, 40), (40, 56), (56, 80)]
    assert part.columns(320) == (64, 160) and part.columns(10) == (2, 5)
    assert part.global_width(24) == 80 and part.global_width(3) == 10
    with pytest.raises(ValueError, match="W/32 = 3 columns of 1/32 cannot split over spatial = 4"):
        spatial.Partition(FakeMesh(4, 0), 96)
    with pytest.raises(ValueError, match="not a multiple of 32"):
        spatial.Partition(FakeMesh(2, 0), 100)
    with pytest.raises(ValueError, match="wider than a neighbour's shard"):
        part.halo(torch.zeros(1, 1, 1, 3), 3, 3)              # 1/32: shards of 2 and 3
    with pytest.raises(ValueError, match="not multiples of 2"):
        with spatial.region(part):
            avg_pool2x(torch.zeros(1, 1, 4, 3))              # 1/32 borders at 2, 5, 7
    with pytest.raises(NotImplementedError, match="InstanceNorm"), spatial.region(part):
        layers.InstanceNorm()(torch.zeros(1, 2, 3, 24))
    assert spatial.partition(None, 320) is None


def test_resolve_vit_attention_under_a_rank_mesh(monkeypatch):
    """"auto" is "flash_sharded" under any mesh of more than one entry (the
    JAX package's rule); on a data 2 x spatial 1 rank mesh, or where the
    heads do not divide, the sharded attention is one K3 call over all heads
    and no collective (there is no process group here to issue one)."""
    class FakeMesh(RankMesh):
        def __init__(self, nd, ns):
            self.shape, self.spatial_index = {"data": nd, "spatial": ns}, 0

    assert resolve_vit_attention("auto") == "flash"
    for shape, want in (((1, 2), "flash_sharded"), ((2, 1), "flash_sharded"),
                        ((1, 1), "flash")):
        with mesh_context(FakeMesh(*shape)):
            assert resolve_vit_attention("auto") == want, shape
            assert resolve_vit_attention("flash") == "flash"
    calls = []
    whole = kernels.flash_attention
    monkeypatch.setattr(kernels, "flash_attention", lambda q, s: calls.append(q.shape) or whole(q, s))
    monkeypatch.setattr(kernels, "flash_attention_heads", None)      # must not be reached
    rng = np.random.default_rng(1)
    spatial.reset_exchanges()
    for shape, heads in (((2, 1), 4), ((1, 2), 3)):
        qkv = _rand(rng, 1, 40, 3, heads, 8)
        got = sharded.flash_attention_sharded(qkv, 0.3, FakeMesh(*shape))
        assert torch.equal(got, whole(qkv, 0.3))
    assert calls == [(1, 40, 3, 4, 8), (1, 40, 3, 3, 8)]
    assert all(v == 0 for v in spatial.EXCHANGES.values())


def test_kernel_mode_under_a_rank_mesh():
    class FakeMesh(RankMesh):
        def __init__(self, nd, ns):
            self.shape = {"data": nd, "spatial": ns}

    pallas = CFG.replace(use_pallas=True)
    assert kernel_mode(pallas, FakeMesh(1, 2), 20) == "rank"
    assert kernel_mode(pallas, FakeMesh(1, 3), 20) == "rank"      # uneven shards are fine
    assert kernel_mode(pallas, FakeMesh(2, 1), 20) == "single"
    assert kernel_mode(pallas, FakeMesh(1, 2), 20, differentiable=True) == "plain"
    assert kernel_mode(CFG.replace(use_pallas=False), FakeMesh(1, 2), 20) == "plain"
