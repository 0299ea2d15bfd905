"""The grower's leaf-sum kernel against its roofline: the least time of its
launches' bytes (``hfbench.counts.gbdt_deep``: node ids, g and h read once,
the float64 sums written once) at the card's memory rate, over the device
time of its two kernels (``leaf_sums_partial`` and ``leaf_sums_merge``).
Only where the window made one launch per stage of its fits."""

KERNELS = ("leaf_sums_partial", "leaf_sums_merge")


def read(s: dict):
    if not s.get("leaf_kernel_bytes") or not s.get("bytes_per_s"):
        return None
    seconds = sum(v[1] for k, v in s.get("device_ops", {}).items()
                  if any(name in k for name in KERNELS))
    if not seconds:
        return None
    return 100.0 * (s["leaf_kernel_bytes"] / s["bytes_per_s"]) / seconds
