"""Seeded weights of the served pipeline, and its contract batches.

Everything is drawn on the device from ``--seed`` at the widths the
configuration file states, as plain tensors in a dict: the job builds the
program's parameter objects from them, and the plain reference reads the
same dict. No fit runs.

  * imputer: ``donors`` rows of all schema columns, non-binary entries
    missing at ``missing_rate``; ``col_means`` their NaN-mean;
  * ``support``: the selected variables' schema positions, ascending (the
    order a lasso support mask yields);
  * scaler: mean and population std of ``svc_fit_rows`` fresh rows of the
    support columns (the rows the SVC was fitted on); the SVC's
    ``svc_support_vectors`` support vectors are a seeded choice of those rows
    standardised, the first ``svc_support_negative`` of class 0 with negative
    dual coefficients, the rest positive, each of magnitude up to C times its
    class weight; ``gamma``, the intercept and Platt's A and B are the
    published values;
  * the GBDT member: ``gbdt_stumps`` stumps on random support columns, each
    threshold a value of a random fit row of that column (unscaled);
  * the L1-LR, with about a third of its coefficients zero and the
    published intercept, and the logistic meta-learner with its published
    weights over (svc, gbdt, lr).

The ranges of what was not published are the configuration's ``assumed``
entries.
"""

from __future__ import annotations

import math

import torch

from hfbench.gen import cohort


def weights(cfg: dict, seed: int, device) -> dict:
    sp = cohort.spec(cfg["cohort"])
    n_cols = len(sp["columns"])
    f64 = torch.float64
    donors = cohort.columns(cfg["donors"], list(range(n_cols)), seed, "pipe.donors", device,
                            missing_rate=cfg["missing_rate"], spec_name=cfg["cohort"])
    support = sorted(cohort.selected_columns(sp))
    F = len(support)
    rows = cohort.columns(cfg["svc_fit_rows"], support, seed, "pipe.svrows", device,
                          spec_name=cfg["cohort"])
    mean = rows.mean(0)
    scale = rows.std(0, unbiased=False)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    a = cfg["assumed"]
    g = cohort.generator(seed, "pipe.coef", device)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, dtype=f64, device=device, generator=g)

    S, neg = cfg["svc_support_vectors"], cfg["svc_support_negative"]
    sv = ((rows - mean) / scale)[torch.randperm(rows.shape[0], device=device, generator=g)[:S]]
    cap = torch.tensor(cfg["svc_class_weight"], dtype=f64, device=device) * cfg["svc_C"]
    is_pos = torch.arange(S, device=device) >= neg
    dual = uniform(a["dual_coef_low"], 1.0, S) * torch.where(is_pos, cap[1], cap[0])
    T = cfg["gbdt_stumps"]
    feat = torch.randint(0, F, (T,), device=device, generator=g)
    pick = torch.randint(0, rows.shape[0], (T,), device=device, generator=g)
    lr_coef = torch.randn(F, dtype=f64, device=device, generator=g) * a["lr_coef_sd"]
    lr_coef = torch.where(torch.rand(F, dtype=f64, device=device, generator=g)
                          < a["lr_zero_share"], 0.0, lr_coef)
    prior = sp["positive_rate"]

    def scalar(key):
        return torch.tensor(cfg[key], dtype=f64, device=device)

    return {
        "donors": donors,
        "col_means": torch.nanmean(donors, dim=0),
        "support": torch.tensor(support, dtype=torch.long, device=device),
        "selected": torch.tensor(cohort.selected_columns(sp), dtype=torch.long, device=device),
        "scaler_mean": mean,
        "scaler_scale": scale,
        "sv": sv,
        "dual_coef": torch.where(is_pos, dual, -dual),
        "svc_intercept": scalar("svc_intercept"),
        "gamma": scalar("svc_gamma"),
        "prob_a": scalar("prob_a"),
        "prob_b": scalar("prob_b"),
        "stump_feature": feat,
        "stump_threshold": rows[pick, feat],
        "stump_left": torch.randn(T, dtype=f64, device=device, generator=g) * a["leaf_sd"],
        "stump_right": torch.randn(T, dtype=f64, device=device, generator=g) * a["leaf_sd"],
        "gbdt_init": torch.tensor(math.log(prior / (1 - prior)), dtype=f64, device=device),
        "gbdt_lr": torch.tensor(cfg["gbdt_learning_rate"], dtype=f64, device=device),
        "lr_coef": lr_coef,
        "lr_intercept": scalar("lr_intercept"),
        "meta_coef": scalar("meta_coef"),
        "meta_intercept": scalar("meta_intercept"),
    }


def contract_batches(cfg: dict, batches: int, rows: int, seed: int, device) -> torch.Tensor:
    """``[batches, rows, 17]`` float64 contract rows (the selected variables
    in contract order, every value present), distinct per batch."""
    sel = cohort.selected_columns(cohort.spec(cfg["cohort"]))
    X = cohort.columns(batches * rows, sel, seed, "pipe.traffic", device, spec_name=cfg["cohort"])
    return X.reshape(batches, rows, len(sel))
