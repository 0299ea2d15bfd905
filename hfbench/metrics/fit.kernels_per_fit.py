"""Card kernels per fit: the profiler's kernel events over the fits of the
traced window (copies and fills not counted)."""


def read(s: dict):
    if s.get("unit") != "fit" or not s["calls"]:
        return None
    return s["kernel_events"] / s["calls"]
