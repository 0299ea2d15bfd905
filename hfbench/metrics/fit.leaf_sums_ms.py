"""Card time per fit in the grower's float64 leaf sums (``gbdt.leaf_sums``),
from the card events the program's spans hold (``hfbench.spanread``)."""


def read(s: dict):
    span = s.get("spans", {}).get("gbdt.leaf_sums")
    if s.get("unit") != "fit" or not s["calls"] or span is None:
        return None
    return 1e3 * span["device_s"] / s["calls"]
