"""Card kernels per CUDA-graph replay of the engine (``engine.replay``): the
replayed graph's kernels, which carry the replay's launch record. A count,
so the profiler's slowdown does not move it."""


def read(s: dict):
    span = s.get("spans", {}).get("engine.replay")
    if s.get("unit") != "batch" or span is None or not span["count"]:
        return None
    return span["kernels"] / span["count"]
