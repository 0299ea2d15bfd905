"""Seeded synthetic cohorts, drawn on the device.

The column marginals and the outcome model are those of the repository's
synthetic cohort (Supplementary Table S1 of the reference; the spec file is
``table_s1.json`` beside this module): binary columns at their prevalence,
continuous columns normal and clipped at 0 (zero-inflated exponential where
the median is 0), ordinal columns with mass halving away from the median
level; the label is drawn from a logistic model over the 17 selected
variables, its intercept calibrated by bisection to the reference's class
prior. The draws come from a ``torch.Generator`` on the device, so a
10M-row cohort costs milliseconds instead of the tens of seconds a host
numpy build takes. The same seed gives the same cohort on the same device.
"""

from __future__ import annotations

import functools
import hashlib
import json
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


@functools.lru_cache(maxsize=None)
def spec(name: str = "table_s1") -> dict:
    """The cohort spec ``<name>.json`` beside this module."""
    return json.loads((HERE / f"{name}.json").read_text())


def column_index(spec_: dict) -> dict[str, int]:
    return {c["name"]: i for i, c in enumerate(spec_["columns"])}


def selected_columns(spec_: dict) -> list[int]:
    """Schema positions of the selected variables, in their contract order."""
    idx = column_index(spec_)
    return [idx[n] for n in spec_["selected"]]


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A generator on ``device`` for one named stream of ``seed``: streams
    are independent, and any whole number is a valid seed."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return g


def _draw(col: dict, n: int, g: torch.Generator, device, zero_inflation: float) -> torch.Tensor:
    """``[n]`` float64 draws of one column."""
    f64 = dict(dtype=torch.float64, device=device, generator=g)
    kind = col["kind"]
    if kind == "binary":
        return (torch.rand(n, **f64) < col["p"]).to(torch.float64)
    if kind == "continuous":
        if col["median"] == 0.0:
            q = zero_inflation
            x = -torch.log1p(-torch.rand(n, **f64)) * (col["mean"] / (1 - q))
            return torch.where(torch.rand(n, **f64) < q, 0.0, x)
        return torch.clamp_min(col["mean"] + col["sd"] * torch.randn(n, **f64), 0.0)
    if kind == "ordinal":
        levels = torch.arange(col["lo"], col["hi"] + 1, dtype=torch.float64, device=device)
        w = 0.5 ** torch.abs(levels - col["median"])
        cdf = torch.cumsum(w / w.sum(), 0)
        cdf[-1] = 1.0
        pick = torch.searchsorted(cdf, torch.rand(n, **f64), right=True)
        return levels[torch.clamp_max(pick, levels.numel() - 1)]
    raise ValueError(f"unknown column kind {kind!r}")


def columns(n: int, cols: list[int], seed: int, stream: str, device, *,
            dtype=torch.float64, missing_rate: float = 0.0,
            spec_name: str = "table_s1") -> torch.Tensor:
    """``[n, len(cols)]`` draws of the schema columns ``cols`` (in that
    order) on ``device``. With ``missing_rate`` each non-binary entry is NaN
    with that probability (binary indicators are always charted)."""
    sp = spec(spec_name)
    g = generator(seed, stream, device)
    out = torch.empty((n, len(cols)), dtype=dtype, device=device)
    for j, c in enumerate(cols):
        col = sp["columns"][c]
        x = _draw(col, n, g, device, sp["zero_inflation"])
        if missing_rate > 0.0 and col["kind"] != "binary":
            x = torch.where(torch.rand(n, dtype=torch.float64, device=device, generator=g)
                            < missing_rate, torch.nan, x)
        out[:, j] = x.to(dtype)
    return out


def labels(X17: torch.Tensor, seed: int, stream: str, *,
           spec_name: str = "table_s1") -> torch.Tensor:
    """``[n]`` 0/1 labels (float64) for the selected variables ``X17`` (in
    contract order): logistic in the standardised columns, the intercept
    bisected on the leading rows to the reference's positive rate."""
    sp = spec(spec_name)
    X = X17.to(torch.float64)
    coef = torch.tensor(sp["outcome_coef"], dtype=torch.float64, device=X.device)
    mu, sd = X.mean(0), X.std(0, unbiased=False) + 1e-12
    logits = ((X - mu) / sd) @ coef
    cal = logits[: min(X.shape[0], sp["calibration_rows"])]
    lo, hi = -20.0, 20.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if float(torch.sigmoid(cal + mid).mean()) > sp["positive_rate"]:
            hi = mid
        else:
            lo = mid
    p = torch.sigmoid(logits + 0.5 * (lo + hi))
    g = generator(seed, stream, X.device)
    return (torch.rand(X.shape[0], dtype=torch.float64, device=X.device, generator=g)
            < p).to(torch.float64)


def gbdt_cohort(n: int, seed: int, device, dtype=torch.float32, spec_name: str = "table_s1"):
    """``(X [n, 17], y [n])`` in ``dtype``: the selected variables in
    contract order and their labels, for the GBDT fits."""
    sel = selected_columns(spec(spec_name))
    X = columns(n, sel, seed, "gbdt.X", device, dtype=torch.float64, spec_name=spec_name)
    y = labels(X, seed, "gbdt.y", spec_name=spec_name)
    return X.to(dtype), y.to(dtype)
