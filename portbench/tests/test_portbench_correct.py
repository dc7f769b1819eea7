"""What decides ``correct``, on the CPU at a tiny size: the reference against
the program's plain path, a sound run passing its cell's limits, and a run
driven with the timed path broken underneath failing them, once for each
fault the cell can have (an answer altered where it is produced: the
served disparity, the classifier's logits, the train-mode forward's stages
and blocks; a train step that leaves its state unchanged; a train step on
half of its batch). The controls (the reference in fp8 in the program's
place) fail them too.

    python3 -m pytest portbench/tests -p no:cacheprovider -o addopts="" -q
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench import control, run, spec
from portbench.reference import model as reference

TINY_MODEL = {"vit_size": "vits", "max_disp": 64, "mixed_precision": False}
PAIRS = {"model": TINY_MODEL, "iters": 2, "mix": {"height": 64, "width": 96, "pool": 3}}
TRAIN = {"model": dict(TINY_MODEL, train_iters=2),
         "mix": {"crop_wh": [96, 64], "max_disparity": 64, "pool": 3, "batch": 2}}


def _run(cell, overrides, seed=2 ** 31 + 5):
    return run.run_cell(cell, seed, 1.0, False, device="cpu", overrides=overrides)


def _failed(result) -> set[str]:
    return {n for n, c in result["checks"].items() if not c["value"] <= c["limit"]}


# -- the reference against the program's plain path -------------------------------


def test_reference_matches_the_program_plain_forward():
    from foundationstereo_torch.config import ModelConfig
    from foundationstereo_torch.models.foundation_stereo import FoundationStereo

    cfg = ModelConfig(vit_size="vits", max_disp=64, mixed_precision=False, use_pallas=False)
    ref = reference.build(dataclasses.asdict(cfg), "cpu", 7)
    prog = FoundationStereo(cfg, device="cpu", seed=0)
    prog.load_state_dict(ref.state_dict(), strict=True)
    g = torch.Generator().manual_seed(1)
    left, right = (torch.rand(1, 64, 96, 3, generator=g) * 255 for _ in range(2))
    caught = {}
    prog.classifier.register_forward_hook(lambda m, a, o: caught.__setitem__("logits", o))
    taps = {}
    with torch.no_grad():
        d_ref = ref(left, right, 3, test_mode=True, taps=taps)
        d_prog = prog(left, right, iters=3, test_mode=True)
    assert (d_ref - d_prog).abs().max() < 1e-3
    assert (taps["classifier"] - caught["logits"]).abs().max() < 1e-4


def test_reference_train_step_matches_the_program():
    """The first step's loss of the program (plain path, fp32) and of the
    reference, from the same weights, batch and dropout key."""
    result_numbers = {}
    from portbench import training

    kind = training.Training(spec.cell("train-vitl-b4"), 3, "cpu", TRAIN)
    kind.setup(run.Parts())
    ref = training.reference_steps(kind.recipe, kind.pool, "cpu", kind.weights_seed)
    result_numbers["first_loss"] = abs(kind.first["loss"][0] - ref["loss"][0]) / ref["loss"][0]
    assert result_numbers["first_loss"] < 1e-5


# -- sound runs pass, broken runs fail ----------------------------------------------


def test_sound_pair_run_is_correct():
    assert _run("pair-vitl-b1", PAIRS)["correct"] is True


def test_altered_answer_fails(monkeypatch):
    """Every disparity off by twice the cell's limit where ``run_pair``
    returns it."""
    from foundationstereo_torch.inference import demo

    orig = demo.run_pair
    off = 2.0 * _limits("pair-vitl-b1")["disp_mae_px"]
    monkeypatch.setattr(demo, "run_pair", lambda *a, **k: orig(*a, **k) + off)
    result = _run("pair-vitl-b1", PAIRS)
    assert result["correct"] is False and "disp_mae_px" in _failed(result)


def test_sound_train_run_is_correct():
    assert _run("train-vitl-b4", TRAIN)["correct"] is True


def test_altered_train_prediction_fails(monkeypatch):
    """The refinement's update of the disparity scaled by 1.5 where the update
    block produces it, in the train-mode forward. Its own block is judged on
    its own input (in train mode the predictions are not held: with batch
    statistics and seeded weights rounding decorrelates them, PERF.md)."""
    from foundationstereo_torch.models.update import BasicSelectiveMultiUpdateBlock

    orig = BasicSelectiveMultiUpdateBlock.forward

    def scaled(self, *a):
        net, mask_feat, delta = orig(self, *a)
        return net, mask_feat, delta * 1.5

    monkeypatch.setattr(BasicSelectiveMultiUpdateBlock, "forward", scaled)
    result = _run("train-vitl-b4", TRAIN)
    assert result["correct"] is False and "update_rel" in _failed(result)


def _scaled(out, k=1.5):
    if isinstance(out, (list, tuple)):
        return type(out)(_scaled(t, k) for t in out)
    return out * k


@pytest.mark.parametrize("module, cls, number", [
    ("cost_filter", "CorrStem", "volume_rel"),
    ("extractor", "ContextNetDino", "context_rel"),
    ("layers", "BasicConv", "filter_block_rel")])
def test_altered_train_forward_stage_fails(monkeypatch, module, cls, number):
    """The filter stack's input volume, the context network's outputs, or
    each conv-norm-activation block's output, scaled by 1.5 where the
    train-mode forward produces them."""
    import importlib

    klass = getattr(importlib.import_module(f"foundationstereo_torch.models.{module}"), cls)
    orig = klass.forward
    monkeypatch.setattr(klass, "forward", lambda self, *a: _scaled(orig(self, *a)))
    result = _run("train-vitl-b4", TRAIN)
    assert result["correct"] is False and number in _failed(result)


@pytest.mark.parametrize("cell, overrides, number", [
    ("pair-vitl-b4", dict(PAIRS, mix={"height": 64, "width": 96, "pool": 2}), "logits_centered_rel"),
    ("train-vitl-b4", TRAIN, "classifier_rel")])
def test_altered_filter_output_fails(monkeypatch, cell, overrides, number):
    from foundationstereo_torch.models.cost_filter import Classifier

    orig = Classifier.forward
    monkeypatch.setattr(Classifier, "forward", lambda self, x: orig(self, x) * 1.5)   # sharper
    result = _run(cell, overrides)
    assert result["correct"] is False and number in _failed(result)


def test_train_step_leaving_its_state_unchanged_fails(monkeypatch):
    from foundationstereo_torch.train.trainer import Trainer

    def apply_nothing(self, state, loss, metrics):
        for p in state.model.parameters():
            p.grad = None
        state.step += 1
        return state, dict(metrics, loss=loss)

    monkeypatch.setattr(Trainer, "_apply_grads", apply_nothing)
    result = _run("train-vitl-b4", TRAIN)
    assert result["correct"] is False and "change_median_gap" in _failed(result)


def test_train_step_on_half_the_batch_fails(monkeypatch):
    from foundationstereo_torch.train.trainer import Trainer

    orig = Trainer.loss_and_grads

    def half(self, state, batch):
        n = batch["left"].shape[0] // 2
        return orig(self, state, {k: (v if k == "rng" else v[:n]) for k, v in batch.items()})

    monkeypatch.setattr(Trainer, "loss_and_grads", half)
    result = _run("train-vitl-b4", TRAIN)
    assert result["correct"] is False and "volume_rel" in _failed(result)


# -- the controls ----------------------------------------------------------------


def _limits(cell):
    return spec.cell(cell)["details"]["checks"]


def test_pairs_control_reads_above_the_program():
    """At the tiny size the fp8 reference in the program's place reads several
    times what the program does (at the cell's own size it fails the limits:
    ``test_controls_fail_the_limits_on_the_card``)."""
    numbers = control.pairs_control(spec.cell("pair-vitl-b1"), 3, torch.device("cpu"), PAIRS)
    sound = _run("pair-vitl-b1", PAIRS, seed=3)["checks"]
    for name, c in sound.items():
        assert numbers[name] > 3 * c["value"], name


@pytest.mark.parametrize("fault", ["fp8", "half_batch"])
def test_train_control_reads_above_the_program(fault):
    numbers = control.train_control(spec.cell("train-vitl-b4"), 3, torch.device("cpu"),
                                    [fault], TRAIN)[fault]
    sound = _run("train-vitl-b4", TRAIN, seed=3)["checks"]
    above = {n for n, c in sound.items() if numbers[n] > 3 * c["value"]}
    blocks = {"filter_block_rel", "classifier_rel", "update_rel"}
    expected = {"volume_rel", "context_rel"} | (blocks if fault == "fp8" else set())
    assert expected <= above, (numbers, sound)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the controls at the cells' own sizes")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["pair-vitl-b1", "pair-vitl-b4", "train-vitl-b4"])
def test_controls_fail_the_limits_on_the_card(card, cell):
    """The control of each cell at its own size, on three seeds: every one
    fails at least one of the cell's limits."""
    c, limits = spec.cell(cell), _limits(cell)
    for seed in (11, 2222222222, 4294967311):
        if c["mix"]["kind"] == "pairs":
            numbers = control.pairs_control(c, seed, card)
        else:
            numbers = control.train_control(c, seed, card, ["fp8"])["fp8"]
        assert any(numbers[n] > lim for n, lim in limits.items()), (cell, seed, numbers)
