"""The port's train-mode forward, loss and gradients against the JAX
package's, on the CPU in fp32, and the training rules of its layers.

* Train-mode outputs: ``apply(test_mode=False, train=False)`` against the
  port's ``forward(test_mode=False, train=False)`` at vits, max_disp 64,
  64x96, 2 iterations: ``init_disp`` and every per-iteration prediction
  within 1e-2 px (the bound of the forward parity test).
* Loss and gradients: one jitted ``Trainer._loss_and_grads`` (with
  ``train_flag=False``, so both sides use running stats and no dropout)
  against the port trainer's ``loss_and_grads``: the loss within 1e-4
  relative, and per parameter tensor ||dg|| / ||g|| <= 1e-3 (measured
  worst 5.9e-4, in the hourglass; a tensor whose gradient vanishes
  mathematically is held to ||dg|| <= 1e-5 of the whole gradient's norm
  instead); the frozen ViT gets no gradient on either side (zeros in JAX,
  ``None`` in the port).
* Batch norm in train mode against flax's ``nn.BatchNorm`` with
  ``mutable=["batch_stats"]``: the output and both running stats.
* Param groups: the port's labels (the name map's flax paths) against the
  JAX package's ``label_params`` on the same tree, for ``"*"`` and for a
  config with exclude patterns.
* Checkpointing: the running stats after one train-mode forward and
  backward, and the gradients with dropout active under one generator seed,
  are the same with ``remat_filter``/``remat_refine``/``scan_upsample`` on
  and off (no double update, the same masks in the recompute).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from foundationstereo_torch.convert.from_jax import (
    flatten_variables,
    jax_to_state_dict,
    load_jax_variables,
)
from foundationstereo_torch.convert.name_map import build_name_map, canonical_path
from foundationstereo_torch.models import layers as tl
from foundationstereo_torch.models.foundation_stereo import FoundationStereo
from foundationstereo_torch.train.optim import label_params
from foundationstereo_torch.train.trainer import Trainer
from foundationstereo_tpu.models import layers as jl
from foundationstereo_tpu.train.optim import label_params as jax_label_params
from foundationstereo_tpu.train.trainer import Trainer as JaxTrainer
from test_torch_modules import CFG, random_variables
from test_trainer import TRAIN_CONFIG, make_batch

ITERS = TRAIN_CONFIG["model"]["train_iters"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs its files in
    parallel workers, and torch's default of one thread per core in each
    oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _JaxTrainerWithOutputs(JaxTrainer):
    """The JAX trainer, with the forward's outputs passed out through the
    loss's metrics (the loss and gradients are unchanged)."""

    def _composite_loss(self, init_disp, preds, gt, mask, label_idx):
        per_sample, metrics = super()._composite_loss(init_disp, preds, gt, mask, label_idx)
        return per_sample, dict(metrics, _init=init_disp, _preds=jnp.stack(preds))


def torch_batch(batch) -> dict:
    return {k: (np.asarray(v) if k == "rng" else torch.from_numpy(np.array(v)))
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_grads():
    batch = make_batch(np.random.default_rng(0))
    jt = _JaxTrainerWithOutputs(TRAIN_CONFIG, seed=0)
    jt.train_flag = False
    v = random_variables(jt.model, np.asarray(batch["left"][:1]), np.asarray(batch["right"][:1]),
                         iters=1, test_mode=False, train=False)
    (loss, (metrics, _)), grads = jax.jit(jt._loss_and_grads)(
        v["params"], v["batch_stats"], batch)
    return v, batch, float(loss), jax.tree.map(np.asarray, metrics), grads


@pytest.fixture(scope="module")
def port_trainer(jax_grads):
    v = jax_grads[0]
    trainer = Trainer(TRAIN_CONFIG, seed=0, device="cpu")
    init = FoundationStereo.init_weights
    FoundationStereo.init_weights = lambda self, gen: None   # every weight is loaded below
    try:
        state = trainer.init_state()
    finally:
        FoundationStereo.init_weights = init
    load_jax_variables(state.model, v)
    return trainer, state


def test_train_mode_outputs_match_jax(jax_grads, port_trainer):
    _, batch, _, metrics, _ = jax_grads
    model = port_trainer[1].model.eval()
    tb = torch_batch(batch)
    with torch.no_grad():
        init_disp, preds = model(tb["left"], tb["right"], iters=ITERS, test_mode=False,
                                 train=False)
    assert init_disp.shape == metrics["_init"].shape == (2, 16, 24)
    assert float(np.abs(init_disp.numpy() - metrics["_init"]).max()) <= 1e-2
    assert len(preds) == ITERS
    for got, want in zip(preds, metrics["_preds"]):
        assert got.shape == want.shape == (2, 64, 96)
        assert float(np.abs(got.numpy() - want).max()) <= 1e-2


def test_loss_and_gradients_match_jax(jax_grads, port_trainer):
    _, batch, jloss, jmetrics, grads = jax_grads
    trainer, state = port_trainer
    trainer.train_flag = False
    model = state.model
    model.zero_grad(set_to_none=True)
    loss, metrics = trainer.loss_and_grads(state, torch_batch(batch))
    assert abs(float(loss) - jloss) <= 1e-4 * abs(jloss)
    for k, v in metrics.items():
        assert abs(float(v) - float(np.mean(jmetrics[k]))) <= 1e-3 * max(1.0, abs(float(v))), k

    want, unmapped = jax_to_state_dict(flatten_variables({"params": grads}), CFG)
    assert not unmapped
    total = np.sqrt(sum(float(np.sum(g.numpy().astype(np.float64) ** 2)) for g in want.values()))
    worst = 0.0
    for name, p in model.named_parameters():
        g = want[name].numpy()
        if name.startswith("feature.dino."):
            assert p.grad is None and not p.requires_grad and not np.any(g), name
            continue
        dg = np.linalg.norm(p.grad.numpy() - g)
        if np.linalg.norm(g) < 1e-5 * total:
            # Gradients that vanish mathematically (a bias before an instance
            # norm or a softmax, the attention keys' bias): rounding on both.
            assert dg <= 1e-5 * total, (name, dg)
            continue
        rel = dg / np.linalg.norm(g)
        worst = max(worst, rel)
        assert rel <= 1e-3, (name, rel)
    assert worst > 0.0
    model.zero_grad(set_to_none=True)


@pytest.mark.parametrize("groups", [
    [{"params": {"include": ["*"], "exclude": []}}],
    [{"params": {"include": ["cost_agg/*", "classifier/*"], "exclude": ["*/bias"]}},
     {"params": {"include": ["*"], "exclude": ["feature/*", "*/scale"]}}],
])
def test_param_groups_match_jax(jax_grads, port_trainer, groups):
    rules = build_name_map(CFG).rules
    want = {}
    for key, lab in flatten_variables({"params": jax_label_params(jax_grads[0]["params"],
                                                                  groups)}).items():
        path = key.split("::", 1)[1]
        want[rules[path if path in rules else canonical_path(path)][0]] = str(lab)
    got = label_params(port_trainer[1].model, groups)
    assert got == want
    assert all(lab == "frozen" for n, lab in got.items() if n.startswith("feature.dino."))
    assert len(set(got.values())) == len(groups) + 1


@pytest.mark.parametrize("shape,dtype", [((3, 8, 5, 7), "float32"),
                                         ((2, 6, 4, 5, 3), "bfloat16")])
def test_batch_norm_train_mode_matches_flax(shape, dtype):
    rng = np.random.default_rng(1)
    x = (2.0 + 3.0 * rng.standard_normal(shape)).astype(np.float32)
    c = shape[1]
    jx = jnp.asarray(np.moveaxis(x, 1, -1)).astype(dtype)
    jm = jl.BatchNorm()
    v = jm.init(jax.random.PRNGKey(0), jx)
    scale = 1.0 + 0.1 * rng.standard_normal(c).astype(np.float32)
    bias = 0.1 * rng.standard_normal(c).astype(np.float32)
    mean0 = 0.1 * rng.standard_normal(c).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    v = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
         "batch_stats": {"BatchNorm_0": {"mean": mean0, "var": var0}}}
    want, mutated = jm.apply(v, jx, train=True, mutable=["batch_stats"])

    tm = tl.BatchNorm(c)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(scale))
        tm.bias.copy_(torch.from_numpy(bias))
        tm.running_mean.copy_(torch.from_numpy(mean0))
        tm.running_var.copy_(torch.from_numpy(var0))
    tm.train()
    got = tm(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.moveaxis(np.asarray(want), -1, 1),
                               rtol=1e-5, atol=1e-5)
    stats = mutated["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(tm.running_mean.numpy(), stats["mean"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tm.running_var.numpy(), stats["var"], rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def small_model(port_trainer):
    model = port_trainer[1].model
    return model, {k: v.clone() for k, v in model.state_dict().items()}


def _train_pass(small_model, remat: bool, seed: int):
    """One train-mode forward and backward from the same weights and stats;
    returns the buffers and gradients after it."""
    model, initial = small_model
    model.load_state_dict(initial)
    model.cfg = CFG.replace(train_iters=ITERS, remat_filter=remat, remat_refine=remat,
                            scan_upsample=remat)
    model.train().zero_grad(set_to_none=True)
    rng = np.random.default_rng(2)
    left, right = (torch.from_numpy(rng.uniform(0, 255, (2, 32, 64, 3)).astype(np.float32))
                   for _ in range(2))
    with tl.dropout_generator(torch.Generator().manual_seed(seed)):
        init_disp, preds = model(left, right, iters=ITERS, test_mode=False, train=True)
        (init_disp.mean() + sum(p.abs().mean() for p in preds)).backward()
    return ({k: b.clone() for k, b in model.named_buffers()},
            {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None})


def test_checkpointing_changes_neither_running_stats_nor_gradients(small_model):
    bufs_on, grads_on = _train_pass(small_model, True, seed=5)
    bufs_off, grads_off = _train_pass(small_model, False, seed=5)
    assert bufs_on.keys() == bufs_off.keys() and grads_on.keys() == grads_off.keys()
    moved = 0
    for k in bufs_on:
        assert torch.equal(bufs_on[k], bufs_off[k]), k       # updated once, not twice
        moved += k.endswith("running_mean") and bool(bufs_on[k].abs().max() > 0)
    assert moved > 0
    for k in grads_on:
        torch.testing.assert_close(grads_on[k], grads_off[k], rtol=1e-5, atol=1e-8, msg=k)
    # The dropout masks matter: another seed moves the transformer's gradients.
    _, grads_other = _train_pass(small_model, False, seed=6)
    key = "cost_agg.atts.4.sa.0.linear2.weight"
    assert not torch.allclose(grads_other[key], grads_off[key], rtol=1e-3, atol=0)


def test_train_mode_needs_a_dropout_generator(small_model):
    model = small_model[0].train()
    x = torch.zeros(1, 32, 64, 3)
    with pytest.raises(RuntimeError, match="dropout needs a generator"):
        model(x, x, iters=1, test_mode=False, train=True)
