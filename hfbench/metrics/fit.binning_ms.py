"""Card time per fit in the binning (``gbdt.binning``: the quantile bins,
their one-byte copy and the per-bin row counts), from the card events the
program's spans hold (``hfbench.spanread``)."""


def read(s: dict):
    span = s.get("spans", {}).get("gbdt.binning")
    if s.get("unit") != "fit" or not s["calls"] or span is None:
        return None
    return 1e3 * span["device_s"] / s["calls"]
