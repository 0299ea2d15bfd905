"""How often a launch of the node entry of the hand histogram kernel walks
its rows, on average over the traced window: its row passes (one per tile of
the launch's plan, ``cuda_histogram.ROW_PASSES``) over its launches
(``cuda_histogram.LAUNCHES``). A count, so the profiler does not move it;
nothing to read where the program keeps no row-pass counter."""


def read(s: dict):
    passes = s.get("row_passes", {}).get("node_histograms")
    launches = s.get("launches", {}).get("node_histograms")
    if not passes or not launches:
        return None
    return passes / launches
