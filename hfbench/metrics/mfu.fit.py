"""The whole fit's share of the card's peak: the least time of one fit's
necessary bytes and operations (``hfbench.counts.gbdt.fit_least``) over the
measured time per fit of the traced window."""


def read(s: dict):
    if s.get("unit") != "fit" or not s.get("least_s_per_call") or not s["calls"]:
        return None
    return 100.0 * s["least_s_per_call"] / (s["window_s"] / s["calls"])
