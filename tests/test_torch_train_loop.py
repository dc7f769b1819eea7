"""The port's losses, optimizer, train-step semantics and checkpoints, on the
CPU.

* Losses and metrics: every ``LOSS_REGISTRY`` function, ``compute_stereo_metrics``
  and the trainer's composite per-label loss against the JAX package's, with
  predictions at the ground truth's resolution and below it: values within
  1e-5 relative (fp32 on both sides; rates are exact).
* LR schedule: the tabulated sympy lambda against the JAX package's at steps
  0, 1000, 159500, 160000, 200000 (float32 on both sides, 1e-6 relative),
  and the join / warmup-cosine / polynomial schedules against optax's.
* AdamW with optax's global-norm clipping: two steps on the same gradients
  (norms above and below the clip) against ``optax.chain(clip_by_global_norm,
  adamw)``, within 1e-7 absolute on weights of a conv kernel's magnitude
  (0.2 N(0, 1)): the decoupled decay is applied in another order, which
  rounds differently by up to an fp32 ulp of the weight.
* Train steps (vits, 32x64, 1 iteration): a step moves trainable weights,
  keeps the frozen ViT bit for bit and moves the EMA; a non-finite batch
  leaves the parameters and the optimizer state (its count too) bit for bit,
  advances ``step`` and moves the EMA; accumulation over two micro-batches
  (train=False) gives the mean of their single gradients.
* Checkpoints: save, restore and ``restore_inference(use_ema)`` round-trip
  bit for bit, with ``latest``, a step number and ``max_to_keep``.
"""

from __future__ import annotations

import copy

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from foundationstereo_torch.train import losses as TL
from foundationstereo_torch.train import optim as TO
from foundationstereo_torch.train.checkpoints import CheckpointManager
from foundationstereo_torch.train.trainer import Trainer, make_label_index
from foundationstereo_tpu.train import losses as JL
from foundationstereo_tpu.train import optim as JO
from foundationstereo_tpu.train.trainer import Trainer as JaxTrainer
from test_trainer import TRAIN_CONFIG

B, H, W = 2, 32, 48


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs its files in
    parallel workers, and torch's default of one thread per core in each
    oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=1e-6)


@pytest.fixture
def loss_inputs():
    rng = np.random.default_rng(0)
    gt = rng.uniform(0, 40, (B, H, W)).astype(np.float32)
    mask = rng.uniform(size=(B, H, W)) > 0.3
    mask[1] = False                                      # an empty mask gives 0
    full = [gt + rng.normal(0, s, (B, H, W)).astype(np.float32) for s in (4.0, 2.0, 0.5)]
    low = [rng.uniform(-5, 50, (B, H // 2, W // 2)).astype(np.float32) for _ in range(3)]
    init = rng.uniform(0, 12, (B, H // 4, W // 4)).astype(np.float32)
    return gt, mask, full, low, init


def _both(fn_name, args, kwargs=None):
    kwargs = kwargs or {}
    conv = lambda a, f: [f(x) for x in a] if isinstance(a, list) else f(a)  # noqa: E731
    j = JL.LOSS_REGISTRY[fn_name](*[conv(a, jnp.asarray) for a in args], **kwargs)
    t = TL.LOSS_REGISTRY[fn_name](*[conv(a, torch.from_numpy) for a in args], **kwargs)
    return t, j


@pytest.mark.parametrize("res", ["full", "low"])
def test_loss_registry_matches_jax(loss_inputs, res):
    gt, mask, full, low, init = loss_inputs
    preds = full if res == "full" else low
    cases = [("disparity_l1_loss", (preds[-1], gt, mask), {}),
             ("disparity_smooth_l1_loss", (preds[-1], gt, mask), {"beta": 0.5}),
             ("foundation_stereo_loss", (init * 4.0, preds, gt, mask), {"gamma": 0.8})]
    if res == "full":
        cases += [("disparity_epe_loss", (preds[-1], gt, mask), {"max_disparity": 30.0}),
                  ("gradient_loss", (preds[-1], gt, mask), {})]
    cases += [("multi_scale_loss", ([low[0], full[1]], gt, mask), {"weights": [0.5, 1.0]}),
              ("multi_scale_loss", ([low[1], full[2]], gt, mask), {"loss_type": "l1"})]
    for name, args, kwargs in cases:
        (tl, tm), (jl, jm) = _both(name, args, kwargs)
        _close(tl, jl)
        assert set(tm) == set(jm), name
        for k in jm:
            _close(tm[k], jm[k])
    for name in ("bp1", "bp3", "d1_error", "d3_error"):
        assert name in _both("disparity_l1_loss", (full[0], gt, mask))[0][1]


def test_stereo_metrics_match_jax(loss_inputs):
    gt, mask, full, _, _ = loss_inputs
    want = JL.compute_stereo_metrics(jnp.asarray(full[0]), jnp.asarray(gt), jnp.asarray(mask))
    got = TL.compute_stereo_metrics(torch.from_numpy(full[0]), torch.from_numpy(gt),
                                    torch.from_numpy(mask))
    assert set(got) == set(want) == {"epe", "rmse", "d1_error", "d3_error", "d5_error"}
    for k in want:
        _close(got[k], want[k])


@pytest.mark.parametrize("res", ["full", "low"])
def test_composite_loss_matches_jax(loss_inputs, res):
    gt, mask, full, low, init = loss_inputs
    preds = full if res == "full" else low
    cfg = copy.deepcopy(TRAIN_CONFIG)
    cfg["loss"]["stereo"]["ms"] = {"function": "multi_scale_loss", "weight": 0.5}
    if res == "full":           # gradient_loss takes the ground truth's resolution only
        cfg["loss"]["stereo"]["grad"] = {"function": "gradient_loss", "weight": 0.3}
    labels = make_label_index(["stereo", "invalid"], cfg["loss"])
    jt = JaxTrainer(cfg)
    jl, jm = jt._composite_loss(jnp.asarray(init), [jnp.asarray(p) for p in preds],
                                jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(labels))
    tt = Trainer(cfg, device="cpu")
    tl, tm = tt.composite_loss(torch.from_numpy(init), [torch.from_numpy(p) for p in preds],
                               torch.from_numpy(gt), torch.from_numpy(mask),
                               torch.from_numpy(labels))
    _close(tl, jl)
    assert set(tm) == set(jm) and any(k.startswith("stereo.ms.") for k in tm)
    for k in jm:
        _close(tm[k], jm[k])


def test_lr_schedule_matches_jax():
    cfg = TRAIN_CONFIG["lr_scheduler"]
    want = JO.build_schedule(cfg, 1e-4)
    got = TO.build_schedule(cfg, 1e-4)
    for step in (0, 1000, 159500, 160000, 200000):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)
    assert abs(got(159500) - 0.55e-4) < 1e-9                 # the table's linear ramp
    others = [{"type": "warmup_cosine", "params": {"warmup_steps": 100, "total_steps": 1000,
                                                   "end_lr": 1e-6}},
              {"type": "poly", "params": {"total_steps": 500, "power": 0.9}},
              {"type": "SequentialLR", "params": {"milestones": [300], "schedulers": [
                  {"type": "poly", "params": {"total_steps": 300, "end_lr": 1e-5}},
                  {"type": "LambdaLR", "params": {"lr_lambda": "0.5"}}]}}]
    for c in others:
        j, t = JO.build_schedule(c, 2e-4), TO.build_schedule(c, 2e-4)
        for step in (0, 50, 100, 299, 300, 301, 700, 1000, 1500):
            np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-5, atol=1e-12)


def test_adamw_with_clipping_matches_optax():
    rng = np.random.default_rng(3)
    shapes = [(4, 3), (7,), (2, 2, 2)]
    params = [0.2 * rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[s * rng.standard_normal(x.shape).astype(np.float32) for x in params]
             for s in (2.0, 0.1)]                         # clipped, then not
    sched = TO.build_schedule(TRAIN_CONFIG["lr_scheduler"], 1e-3)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(JO.build_schedule(TRAIN_CONFIG["lr_scheduler"], 1e-3),
                                 b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2))
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = TO.ScheduledOptimizer(torch.optim.AdamW(
        [{"params": tp, "lr": 1e-3, "betas": (0.9, 0.999), "eps": 1e-8,
          "weight_decay": 1e-2}]), [sched])
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        tg = [p.grad for p in tp]
        TO.clip_by_global_norm(tg, TO.global_norm(tg))
        opt.step()
    assert opt.count == 2
    for p, j in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), rtol=0, atol=1e-7)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

SMALL = copy.deepcopy(TRAIN_CONFIG)
SMALL["model"]["train_iters"] = 1


def small_batch(seed, h=32, w=64):
    rng = np.random.default_rng(seed)
    return {"left": torch.from_numpy(rng.uniform(0, 255, (2, h, w, 3)).astype(np.float32)),
            "right": torch.from_numpy(rng.uniform(0, 255, (2, h, w, 3)).astype(np.float32)),
            "disparity": torch.from_numpy(rng.uniform(0, 20, (2, h, w)).astype(np.float32)),
            "mask": torch.from_numpy(rng.uniform(size=(2, h, w)) > 0.2),
            "label_idx": torch.from_numpy(make_label_index(["stereo", "stereo"], SMALL["loss"])),
            "rng": np.array([0, seed], np.uint32)}


@pytest.fixture(scope="module")
def trainer_state():
    trainer = Trainer(SMALL, seed=0, device="cpu")
    return trainer, trainer.init_state()


def _params(state):
    return {k: v.detach().clone() for k, v in state.model.named_parameters()}


def test_train_step_and_nonfinite_skip(trainer_state):
    trainer, state = trainer_state
    before, ema0 = _params(state), {k: v.clone() for k, v in state.ema.items()}
    state, metrics = trainer.train_step(state, small_batch(1))
    assert float(metrics["skipped_nonfinite"]) == 0.0 and np.isfinite(float(metrics["loss"]))
    assert {"loss", "grad_norm", "skipped_nonfinite", "stereo.foundation_stereo.final_epe"} \
        <= set(metrics)
    after = _params(state)
    for k in before:
        if k.startswith("feature.dino."):
            assert torch.equal(before[k], after[k]), k
    assert not torch.equal(before["update_block.disp_head.conv.0.weight"],
                           after["update_block.disp_head.conv.0.weight"])
    assert not torch.equal(ema0["update_block.disp_head.conv.0.weight"],
                           state.ema["update_block.disp_head.conv.0.weight"])
    assert state.step == 1 and state.optimizer.count == 1

    bad = small_batch(2)
    bad["left"][0, 0, 0, 0] = float("nan")
    stats = {k: b.clone() for k, b in state.model.named_buffers()}
    opt_before = copy.deepcopy(state.optimizer.state_dict())
    ema1 = {k: v.clone() for k, v in state.ema.items()}
    lr_before = state.optimizer.lrs()
    state, metrics = trainer.train_step(state, bad)
    assert float(metrics["skipped_nonfinite"]) == 1.0
    for k, v in _params(state).items():
        assert torch.equal(v, after[k]), k
    opt_after = state.optimizer.state_dict()
    assert opt_after["count"] == opt_before["count"] == 1 and state.optimizer.lrs() == lr_before
    for i, s in opt_before["optimizer"]["state"].items():
        for key, val in s.items():
            assert torch.equal(val, opt_after["optimizer"]["state"][i][key]), (i, key)
    assert state.step == 2
    moved = ema1["update_block.disp_head.conv.0.weight"] - state.ema["update_block.disp_head.conv.0.weight"]
    assert float(moved.abs().max()) > 0
    # The batch stats took the (non-finite) batch's update, as in the JAX
    # step; put them back for the other tests.
    assert torch.isnan(state.model.cnet.norm1.running_mean).all()
    for k, b in state.model.named_buffers():
        b.copy_(stats[k])


def test_accumulation_is_the_mean_of_single_gradients(trainer_state):
    trainer, state = trainer_state
    trainer.train_flag = False
    try:
        singles = []
        for seed in (3, 4):
            state.model.zero_grad(set_to_none=True)
            trainer.loss_and_grads(state, small_batch(seed))
            singles.append({k: p.grad.clone() for k, p in state.model.named_parameters()
                            if p.grad is not None})
        state.model.zero_grad(set_to_none=True)
        captured = {}
        trainer._apply_grads = lambda st, loss, m: captured.update(
            {k: p.grad.clone() for k, p in st.model.named_parameters()
             if p.grad is not None}) or (st, m)
        trainer.train_step_accum(state, [small_batch(3), small_batch(4)])
    finally:
        del trainer._apply_grads
        trainer.train_flag = True
        state.model.zero_grad(set_to_none=True)
    assert set(captured) == set(singles[0])
    for k in captured:
        torch.testing.assert_close(captured[k], (singles[0][k] + singles[1][k]) / 2,
                                   rtol=1e-5, atol=1e-9)


def test_checkpoints_round_trip(tmp_path, trainer_state):
    trainer, state = trainer_state
    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
    assert mgr.latest_step() is None
    assert mgr.restore("latest", state) == (state, 0)
    for s in (3, 5, 7):
        state.step = s
        mgr.save(s, state, config=SMALL)
    mgr.wait()
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    ema = {k: v.clone() for k, v in state.ema.items()}
    count = state.optimizer.count
    with torch.no_grad():                    # move everything, then restore step 5
        for t in list(want_params(state)) + list(state.ema.values()):
            t.add_(1.0)
    state.optimizer.count, state.step = 99, 99
    assert mgr.steps() == [5, 7] and mgr.latest_step() == 7
    assert {p.name for p in (tmp_path / "ckpt").iterdir()} == {
        "5.pt", "5_ema.pt", "5_optimizer.pt", "7.pt", "7_ema.pt", "7_optimizer.pt",
        "latest.pt", "config.json"}
    restored, step = mgr.restore(5, state)
    assert step == 5 and restored.step == 5 and restored.optimizer.count == count
    for k, v in restored.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    for k, v in restored.ema.items():
        assert torch.equal(v, ema[k]), k
    sd, step = mgr.restore_inference("latest", use_ema=True)
    assert step == 7 and set(sd) == set(want)
    for k, v in sd.items():
        assert torch.equal(v, ema[k] if k in ema else want[k]), k
    sd, _ = mgr.restore_inference(7)
    assert all(torch.equal(v, want[k]) for k, v in sd.items())
    mgr.close()


def want_params(state):
    return (p.data for p in state.model.parameters())
