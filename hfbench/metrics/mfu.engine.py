"""The whole predict step's share of the card's peak: the least time of one
batch's float64 operations and bytes (``hfbench.counts.pipeline``) over the
measured time per batch of the traced window. That time includes the
profiler's own cost (about 16-19 ms a batch traced against about 7 ms
untraced, NVIDIA H100 80GB HBM3), so the share reads about 2.5 times lower
than an untraced batch's would."""


def read(s: dict):
    if s.get("unit") != "batch" or not s.get("least_s_per_call") or not s["calls"]:
        return None
    return 100.0 * s["least_s_per_call"] / (s["window_s"] / s["calls"])
