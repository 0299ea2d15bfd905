"""Card time per fit in the split search and the row routing
(``gbdt.split`` and ``gbdt.route``: cumulative sums, split selection, Newton
values, forest writes, the split column and the child ids), from the card
events the program's spans hold (``hfbench.spanread``)."""


def read(s: dict):
    spans = s.get("spans", {})
    parts = [spans[k] for k in ("gbdt.split", "gbdt.route") if k in spans]
    if s.get("unit") != "fit" or not s["calls"] or not parts:
        return None
    return 1e3 * sum(p["device_s"] for p in parts) / s["calls"]
