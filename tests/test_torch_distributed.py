"""Data-parallel training of the port on the CPU: ranks over ``gloo`` in
spawned processes against one process on the global batch.

* ``BatchNorm`` inside ``layers.global_batch`` on 2 ranks against
  ``BatchNorm`` on the concatenated batch: the output, both running stats,
  the input gradients and the summed parameter gradients within 1e-6.
* One ``Trainer.train_step`` on 4 ranks on a global batch of 4 (dropout
  active, one ``rng``, batch statistics in training, the checkpointed
  regions on) against the one-process step on the same batch: the loss
  within 1e-6 relative; the running stats and the EMA within 1e-6; the
  gradients within the one-process step's own reproducibility (below);
  the update bit for bit the one-process optimizer's on the ranks' averaged
  gradient; every rank's parameters, stats and EMA bit for bit rank 0's.

  How close the gradients can be: this model at random weights carries a
  rounding difference of its forward (1e-7 relative) through the 3D
  hourglass to 5e-5 at the classifier, and its gradients to ~1e-2. The
  one-process step against itself on 2 torch threads instead of 1 differs
  by 1.4e-2 in |dg| / |g| over all gradients, by 1.9e-2 in the worst
  tensor (5.7e-3 the median), and by 2e-4 in the parameters after the
  update (AdamW's first step is lr * g / (|g| + eps): a gradient element at
  the noise level takes +-lr). So the 4 ranks, whose sums run in another
  order, are held to 5e-2 over all gradients, 1e-1 per tensor (a tensor
  whose gradient vanishes, |g| < 1e-5 of the whole, to |dg| <= 1e-5 of the
  whole, as in ``test_torch_train.py``) and 1e-2 on the gradient norm; and
  the update is checked by replaying the one-process optimizer on rank 0's
  averaged gradient. Measured on the CPU: 1.6e-2, 2.4e-2 and 2.4e-4. Faults
  of the data-parallel semantics land far outside: each rank drawing its own
  dropout mask gave 1.34 over all gradients, batch-norm statistics whose
  gradient is not all-reduced 0.37 (worst tensor 8.0), and statistics not
  all-reduced at all made the ranks' running stats differ.
* The train CLI with ``--device cpu --n_devices 2`` (laid out as the JAX
  CLI's ``make_mesh(2)``: data 1 x spatial 2, each sample split along width):
  2 steps, then a resume from ``latest``; rank 0 alone writes
  ``metrics.jsonl`` and the checkpoints; plans that cannot run (a batch the
  data axis does not split among them) raise before any rank starts.

The one-process step is held against the JAX package's step in
``test_torch_train.py``; the JAX package defines the sharded step as the
one-device step on the global batch (``foundationstereo_tpu/train/
trainer.py:6-9``), which is what this file holds the ranks to. The model
is ``test_trainer.TRAIN_CONFIG``'s (vits, 64x96, 2 iterations, fp32),
copied here: this file imports no JAX, because every spawned rank imports
it again. Ranks meet through a ``file://`` rendezvous in the test's
temporary directory and run torch on one thread.
"""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from foundationstereo_torch.models import layers
from foundationstereo_torch.parallel import distributed
from foundationstereo_torch.train import cli
from foundationstereo_torch.train.optim import build_optimizer, ema_init
from foundationstereo_torch.train.trainer import Trainer, make_label_index

TRAIN_CONFIG = {
    "model": {
        "max_disp": 64, "vit_size": "vits", "mixed_precision": False,
        "train_iters": 2, "valid_iters": 3,
        "corr_radius": 4, "corr_levels": 4, "n_gru_layers": 3,
        "hidden_dims": [128, 128, 128],
    },
    "loss": {
        "stereo": {"foundation_stereo": {
            "function": "foundation_stereo_loss", "weight": 1.0,
            "params": {"gamma": 0.9, "max_disparity": 192.0}}},
        "invalid": {"dummy": {
            "function": "disparity_l1_loss", "weight": 0.0,
            "params": {"max_disparity": 192.0}}},
    },
    "optimizer": {
        "type": "AdamW",
        "params": [{"params": {"include": ["*"], "exclude": []},
                    "lr": 1e-4, "weight_decay": 1e-4,
                    "betas": [0.9, 0.999], "eps": 1e-8}],
    },
    "lr_scheduler": {
        "type": "LambdaLR",
        "params": {"lr_lambda": "Piecewise((1.0, epoch < 160000), (0.1, True))"},
    },
}
H, W = 64, 96


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's own process: the suite runs
    its files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rank_entry(rank: int, fn, world: int, url: str, args: tuple) -> None:
    torch.set_num_threads(1)
    distributed.initialize(url, world, rank, backend="gloo")
    try:
        fn(rank, *args)
    finally:
        torch.distributed.destroy_process_group()


def _start_ranks(fn, world: int, tmp_path: Path, *args):
    """``fn(rank, *args)`` in ``world`` spawned ranks of one gloo group;
    returns the context to ``join``."""
    url = (tmp_path / "rendezvous").absolute().as_uri()
    return mp.spawn(_rank_entry, args=(fn, world, url, args), nprocs=world, join=False)


def _join(ctx) -> None:
    while not ctx.join(timeout=300):
        pass


# ---------------------------------------------------------------------------
# batch norm
# ---------------------------------------------------------------------------

def _bn_case(shape):
    rng = np.random.default_rng(sum(shape))
    c = shape[1]
    x = torch.from_numpy(rng.normal(0.5, 2.0, shape).astype(np.float32))
    cot = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
    bn = layers.BatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.normal(0, 1, c).astype(np.float32)))
        bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 1, c).astype(np.float32)))
    return x, cot, bn.train()


def _bn_outputs(bn, x, cot, out_path=None):
    x = x.clone().requires_grad_()
    y = bn(x)
    (y * cot).sum().backward()
    out = {"y": y.detach(), "dx": x.grad, "mean": bn.running_mean.clone(),
           "var": bn.running_var.clone(), "dw": bn.weight.grad, "db": bn.bias.grad}
    if out_path is not None:
        torch.save(out, out_path)
    return out


def _bn_rank(rank: int, shape, out_dir: Path) -> None:
    x, cot, bn = _bn_case(shape)
    rows = slice(rank * shape[0] // 2, (rank + 1) * shape[0] // 2)
    with layers.global_batch():
        _bn_outputs(bn, x[rows], cot[rows], out_dir / f"bn{rank}.pt")


@pytest.mark.parametrize("shape", [(4, 6, 5, 7), (4, 3, 2, 5, 6)], ids=["2d", "3d"])
def test_batch_norm_on_two_ranks_is_batch_norm_on_the_global_batch(tmp_path, shape):
    _join(_start_ranks(_bn_rank, 2, tmp_path, shape, tmp_path))
    x, cot, bn = _bn_case(shape)
    want = _bn_outputs(bn, x, cot)
    got = [torch.load(tmp_path / f"bn{r}.pt") for r in range(2)]
    for key in ("y", "dx"):
        torch.testing.assert_close(torch.cat([g[key] for g in got]), want[key], rtol=0, atol=1e-6)
    for key in ("mean", "var"):
        for g in got:
            torch.testing.assert_close(g[key], want[key], rtol=0, atol=1e-6)
    for key in ("dw", "db"):      # each rank holds its slice's part of the global loss's gradient
        torch.testing.assert_close(got[0][key] + got[1][key], want[key], rtol=0, atol=1e-5)


def test_global_batch_changes_nothing_without_a_group():
    x, cot, bn = _bn_case((4, 6, 5, 7))
    want = _bn_outputs(copy.deepcopy(bn), x, cot)
    with layers.global_batch():
        got = _bn_outputs(bn, x, cot)
    for key in want:
        assert torch.equal(got[key], want[key]), key


# ---------------------------------------------------------------------------
# one train step on 4 ranks
# ---------------------------------------------------------------------------

def _global_batch(b: int = 4) -> dict:
    rng = np.random.default_rng(11)
    return {"left": torch.from_numpy(rng.uniform(0, 255, (b, H, W, 3)).astype(np.float32)),
            "right": torch.from_numpy(rng.uniform(0, 255, (b, H, W, 3)).astype(np.float32)),
            "disparity": torch.from_numpy(rng.uniform(1, 30, (b, H, W)).astype(np.float32)),
            "mask": torch.from_numpy(rng.uniform(size=(b, H, W)) > 0.2),
            "label_idx": torch.from_numpy(make_label_index(["stereo"] * b, TRAIN_CONFIG["loss"])),
            "rng": np.array([5, 7], np.uint32)}


def _one_step(batch: dict) -> tuple[dict, Trainer, object, dict]:
    """One ``train_step`` from the seeded state: its metrics, the gradients
    it applied, the running stats, parameters and EMA after it, and the
    checksums of what the ranks must hold alike; and the trainer, the state
    and the parameters before the step."""
    trainer = Trainer(TRAIN_CONFIG, seed=0, device="cpu")
    state = trainer.init_state()
    before = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    grads = {}
    apply = trainer._apply_grads

    def capture(st, loss, metrics):
        grads.update({k: p.grad.clone() for k, p in st.model.named_parameters()
                      if p.grad is not None})
        return apply(st, loss, metrics)

    trainer._apply_grads = capture
    state, metrics = trainer.train_step(state, batch)
    del trainer._apply_grads
    replicas = cli.replica_tensors(state)
    distributed.check_replicas(replicas)
    out = {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
           "buffers": {k: b.clone() for k, b in state.model.named_buffers()},
           "params": {k: p.detach().clone() for k, p in state.model.named_parameters()},
           "ema": {k: v.clone() for k, v in state.ema.items()},
           "checksums": distributed.checksums(list(replicas.values()))}
    return out, trainer, state, before


def _replay_update(trainer, state, before: dict, grads: dict, loss: float):
    """The one-process update (clipping by the global norm, AdamW, the EMA)
    from the parameters ``before`` a step, given that step's gradients."""
    with torch.no_grad():
        for k, p in state.model.named_parameters():
            p.copy_(before[k])
            p.grad = grads.get(k)
    state.optimizer, _ = build_optimizer(state.model, TRAIN_CONFIG["optimizer"],
                                         TRAIN_CONFIG["lr_scheduler"])
    state.ema = ema_init(state.model)
    trainer._apply_grads(state, torch.tensor(loss), {})
    return state


def _step_rank(rank: int, out_dir: Path) -> None:
    out = _one_step(distributed.local_slice(_global_batch()))[0]
    if rank:
        out = {"checksums": out["checksums"]}
    torch.save(out, out_dir / f"step{rank}.pt")


def test_train_step_on_four_ranks_is_the_one_process_step(tmp_path):
    ctx = _start_ranks(_step_rank, 4, tmp_path, tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)                  # the ranks' count: the same sums within a rank
    try:
        want, trainer, state, before = _one_step(_global_batch())
    finally:
        torch.set_num_threads(threads)
    _join(ctx)
    got = torch.load(tmp_path / "step0.pt")
    for r in range(1, 4):
        assert torch.equal(torch.load(tmp_path / f"step{r}.pt")["checksums"], got["checksums"]), r
    for r in range(4):
        (tmp_path / f"step{r}.pt").unlink()          # 0.6 GB: the suite shares one disk
    m, w = got["metrics"], want["metrics"]
    assert m["skipped_nonfinite"] == w["skipped_nonfinite"] == 0.0
    assert abs(m["loss"] - w["loss"]) <= 1e-6 * abs(w["loss"]), (m["loss"], w["loss"])
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
    moved = want["buffers"]["cnet.norm1.running_mean"]
    assert float(moved.abs().max()) > 0       # the step took batch statistics

    torch.set_num_threads(1)
    try:
        state = _replay_update(trainer, state, before, got["grads"], m["loss"])
    finally:
        torch.set_num_threads(threads)
    for k, p in state.model.named_parameters():
        assert torch.equal(p, got["params"][k]), k
        assert torch.equal(state.ema[k], got["ema"][k]), k


# ---------------------------------------------------------------------------
# the train CLI on 2 ranks
# ---------------------------------------------------------------------------

def _write_dataset(root: Path, n: int = 4) -> Path:
    from PIL import Image

    from foundationstereo_torch.utils.misc import depth_uint8_encoding

    rng = np.random.default_rng(3)
    for sub in ("left/rgb", "right/rgb", "left/disparity"):
        (root / sub).mkdir(parents=True)
    for i in range(n):
        for side in ("left", "right"):
            img = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
            Image.fromarray(img).save(root / f"{side}/rgb/{i}.jpg")
        disp = rng.uniform(1, 30, (H, W)).astype(np.float32)
        Image.fromarray(depth_uint8_encoding(disp)).save(root / f"left/disparity/{i}.png")
    return root


def _cli_args(tmp_path: Path, data: Path, steps: int, ckpt: str, *extra) -> list[str]:
    repo = Path(__file__).resolve().parent.parent
    return ["--config", str(repo / "configs/train/stereo_v1.json"),
            "--workspace", str(tmp_path / "ws"), "--device", "cpu",
            "--num_iterations", str(steps), "--batch_size", "2", "--save_every", "1",
            "--log_every", "1", "--checkpoint", ckpt,
            "--override", "model.vit_size=vits", "--override", "model.max_disp=64",
            "--override", "model.train_iters=1", "--override", "model.mixed_precision=false",
            "--override", "data.image_sizes=[[96,64]]", "--override", "data.max_disparity=64",
            "--override", f"data.datasets.0.path={data}", *extra]


def test_train_cli_on_two_ranks_runs_and_resumes(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")       # each spawned rank's torch threads
    data = _write_dataset(tmp_path / "data")
    ws = tmp_path / "ws"
    line = cli.main(_cli_args(tmp_path, data, 2, "none", "--n_devices", "2"))
    assert line["step"] == 1 and np.isfinite(line["loss"])
    lines = [json.loads(x) for x in (ws / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [0, 1]
    for x in lines:
        assert np.isfinite(x["loss"]) and np.isfinite(x["grad_norm"])
        assert x["skipped_nonfinite"] == 0.0
    ckpts = ws / "checkpoints"
    assert {p.name for p in ckpts.iterdir()} == {
        "1.pt", "1_ema.pt", "1_optimizer.pt", "2.pt", "2_ema.pt", "2_optimizer.pt",
        "latest.pt", "config.json"}

    line = cli.main(_cli_args(tmp_path, data, 3, "latest", "--n_devices", "2"))
    assert line["step"] == 2 and np.isfinite(line["loss"])
    lines = [json.loads(x) for x in (ws / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [0, 1, 2]
    assert torch.load(ckpts / "latest.pt")["step"] == 3
    assert torch.load(ckpts / "3_optimizer.pt")["optimizer"]["count"] == 3
    shutil.rmtree(ckpts)                             # 2.2 GB: the suite shares one disk


def _plan(tmp_path, *extra):
    return cli.plan_ranks(cli.parse_args(_cli_args(tmp_path, tmp_path, 1, "none", *extra)))


def test_plan_ranks(tmp_path, monkeypatch):
    """(data, spatial, backend), factored as the JAX package's make_mesh."""
    assert _plan(tmp_path) == (1, 1, "gloo")                 # --n_devices 0 on the CPU: one
    assert _plan(tmp_path, "--n_devices", "2") == (1, 2, "gloo")
    assert _plan(tmp_path, "--n_devices", "8") == (2, 4, "gloo")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert _plan(tmp_path) == (1, 2, "gloo")                 # a launcher's group
    with pytest.raises(ValueError, match="WORLD_SIZE is 2"):
        _plan(tmp_path, "--n_devices", "4")


@pytest.mark.parametrize("extra, match", [
    (("--n_devices", "6"), "does not split over the 3 data ranks of 6 = data 3 x spatial 2"),
    (("--n_devices", "2", "--dist_backend", "nccl"), "nccl needs --device cuda"),
    (("--device", "cuda:0", "--n_devices", "2"), "NCCL refuses two ranks on one device"),
], ids=["batch", "nccl_on_cpu", "nccl_ranks_over_cards"])
def test_plans_that_cannot_run_raise_before_any_rank_starts(tmp_path, monkeypatch, extra, match):
    if "cuda:0" in extra:                                    # one card, seen from the CPU
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    spawned = []
    monkeypatch.setattr(mp, "spawn", lambda *a, **k: spawned.append(a))
    with pytest.raises(ValueError, match=match):
        cli.main(_cli_args(tmp_path, tmp_path, 1, "none", *extra))
    assert not spawned


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(_cli_args(tmp_path, tmp_path, 1, "none", "--device", "cuda", "--n_devices", "2"))


def test_step_rng_is_keyed_on_seed_step_and_micro_batch():
    a = cli.step_rng(0, 5)
    assert a.dtype == np.uint32 and a.shape == (2,)
    assert np.array_equal(a, cli.step_rng(0, 5))
    assert not np.array_equal(a, cli.step_rng(0, 6))
    assert not np.array_equal(a, cli.step_rng(1, 5))
    assert not np.array_equal(a, cli.step_rng(0, 5, 1))


def test_checksums_tell_bit_patterns_apart():
    x = torch.tensor([1.0, -0.0, 3.5])
    y = x.clone()
    y[1] = 0.0                                              # -0.0 and 0.0 differ in one bit
    ints = torch.arange(5, dtype=torch.int64)
    a = distributed.checksums([x, x.to(torch.bfloat16), ints])
    assert a.dtype == torch.int64 and a.shape == (3,)
    assert torch.equal(a, distributed.checksums([x.clone(), x.to(torch.bfloat16), ints.clone()]))
    assert not torch.equal(distributed.checksums([x]), distributed.checksums([y]))
    distributed.check_replicas({"x": x})                     # one process: nothing to compare
