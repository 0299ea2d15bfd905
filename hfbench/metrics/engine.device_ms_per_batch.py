"""Card time per served batch: the union of the card's busy intervals
(copy-in, graph replay, copy-out) over the batches of the traced window."""


def read(s: dict):
    if s.get("unit") != "batch" or not s["calls"]:
        return None
    return 1e3 * s["busy_s"] / s["calls"]
