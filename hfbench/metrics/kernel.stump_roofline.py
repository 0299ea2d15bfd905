"""The stump entry of the hand histogram kernel against its roofline: the
least time of its launches' bytes at the card's memory rate, over the
kernel's device time. Only where every launch of the window was a stump
launch, as many as the fits need."""


def read(s: dict):
    launches = s.get("launches", {})
    if not launches.get("stump_histograms") or launches.get("node_histograms"):
        return None
    if not s.get("hand_kernel_bytes") or not s.get("hand_kernel_s"):
        return None
    return 100.0 * (s["hand_kernel_bytes"] / s["bytes_per_s"]) / s["hand_kernel_s"]
