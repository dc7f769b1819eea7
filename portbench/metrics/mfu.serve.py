"""The whole pair's share of the card's bf16 peak, in %: the
reference's matrix-unit FLOPs per pair (counted once per shape with
``torch.utils.flop_counter`` on the meta device) times the items of the traced run's plain half,
over its seconds times 989 TF/s."""

from portbench.counting import PEAK_BF16_FLOPS


def read(rec):
    if rec["kind"] != "pairs" or not rec.get("flops_per_item"):
        return None
    w = rec["window"]
    return 100.0 * rec["flops_per_item"] * w["items"] / (w["seconds"] * PEAK_BF16_FLOPS)
