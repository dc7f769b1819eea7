"""The whole train step's share of the cards' bf16 peak, in %: the
reference's matrix-unit FLOPs per sample (counted once per shape with
``torch.utils.flop_counter`` on the meta device: forward and backward,
without recompute) times the items of the traced run's plain half (on N
ranks every rank's), over its seconds times the cell's chips times
989 TF/s."""

from portbench.counting import PEAK_BF16_FLOPS


def read(rec):
    if rec["kind"] != "train_batches" or not rec.get("flops_per_item"):
        return None
    w = rec["window"]
    return 100.0 * rec["flops_per_item"] * w["items"] / (
        w["seconds"] * rec.get("chips", 1) * PEAK_BF16_FLOPS)
