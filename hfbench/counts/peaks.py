"""Published peaks of the NVIDIA H100 by part (data sheets, dense rates, no
sparsity, at the full power limit): HBM bytes/s; float32 and float64 rates
outside the tensor cores, and float64 on the tensor cores."""

from __future__ import annotations

PEAKS = {
    "SXM": {"bytes": 3.35e12, "float32": 67e12, "float64": 34e12, "float64_tensor": 67e12},
    "PCIe": {"bytes": 2.0e12, "float32": 51e12, "float64": 26e12, "float64_tensor": 51e12},
    "NVL": {"bytes": 3.9e12, "float32": 60e12, "float64": 30e12, "float64_tensor": 60e12},
}


def part_of(device_name: str) -> str:
    """The H100 part a device name denotes (SXM unless it says PCIe or NVL)."""
    for part in ("PCIe", "NVL"):
        if part.lower() in device_name.lower():
            return part
    return "SXM"


def peaks_for(device_name: str) -> dict:
    return PEAKS[part_of(device_name)]


def least_seconds(nbytes: float, ops: float, bytes_per_s: float, ops_per_s: float) -> dict:
    """The least time for the work: bytes over the memory rate, operations
    over the arithmetic rate; the larger binds."""
    by_bytes, by_ops = nbytes / bytes_per_s, ops / ops_per_s
    return {"seconds": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "ops",
            "bytes": nbytes, "ops": ops}
