"""The card's idle share of the traced window of fits: 1 - busy / window."""


def read(s: dict):
    if s.get("unit") != "fit" or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
