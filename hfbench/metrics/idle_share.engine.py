"""The card's idle share of the traced window of batches: 1 - busy / window.

It includes the profiler's own cost: under the profiler the card waits on
the host inside each graph replay (NVIDIA H100 80GB HBM3: 15.7-18.0 ms from
a batch's first to its last card activity, of which 6.84 ms busy, against
about 7 ms a batch untraced). It moves with the host's share of a batch,
which the profiler magnifies; it is no reading of the untraced idle time."""


def read(s: dict):
    if s.get("unit") != "batch" or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
