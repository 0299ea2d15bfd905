"""Runs ``models.gbdt.fit`` at depth: ``gbdt_fit``'s whole fits back to back
on one resident data set, held to the level-wise reference.

It is ``jobs/gbdt_fit.py``'s ``GBDTFit`` (set-up, timed call, end-to-end
metric) with these differences:

  * ``reference()`` fits ``reference/gbdt_deep.py``, which makes one pass a
    level where ``reference/gbdt.py`` loops over nodes (minutes a fit at
    depth 8 and millions of rows);
  * the check's numbers (``gaps``) are two deviances, not the raw-score
    gap. A depth-8 fit of 10.5M rows makes 12,750 split decisions; on an
    H100 the program's float32 node sums put one to three near ties (a
    proxy within 1e-4 of the best) the other way in about half the seeds,
    and from there the program and the reference are two fits of equal quality
    whose scores differ by up to about 1.2 on some row, as much as the
    reference in bfloat16 differs. ``dev_gap`` is the largest relative
    difference of the deviance paths over the stages; ``forest_dev_gap``
    that of the final deviance of the returned forest's own raw scores on
    the rows (so a forest that predicts otherwise than the fit trained is
    seen);
  * ``trace_extras`` adds ``row_passes``, the change of
    ``cuda_histogram.ROW_PASSES`` over the window by kernel, where the
    program keeps that counter (nothing is added where it does not);
  * it adds ``leaf_kernel_bytes``, the bytes the window's leaf-sum launches
    must move (``counts/gbdt_deep.py``), where the window made one launch a
    stage;
  * ``FAULTS`` adds ``shallow``: fits that grow ``SHALLOW_DEPTH`` levels
    instead of the cell's, which the check has to see.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from hfbench.counts import gbdt_deep as deep_counts
from hfbench.jobs import gbdt_fit
from hfbench.reference import gbdt as reference
from hfbench.reference import gbdt_deep

SHALLOW_DEPTH = 5


def _row_passes():
    from machine_learning_replications_tpu_torch.ops import cuda_histogram

    passes = getattr(cuda_histogram, "ROW_PASSES", None)
    return None if passes is None else dict(passes)


class GBDTDeepFit(gbdt_fit.GBDTFit):
    def __init__(self, config: dict, cell: dict, seed: int, dev: torch.device):
        super().__init__(config, cell, seed, dev)
        self._passes0 = None

    def call(self, i: int) -> None:
        if i == 0:
            self._passes0 = _row_passes()
        super().call(i)

    def trace_extras(self, summary: dict) -> None:
        super().trace_extras(summary)
        after = _row_passes()
        if after is not None and self._passes0 is not None:
            summary["row_passes"] = {k: after[k] - self._passes0.get(k, 0) for k in after}
        shape, fits = self._shape(), summary["calls"]
        if summary["launches"].get("leaf_sums", 0) == shape["stages"] * fits:
            summary["leaf_kernel_bytes"] = fits * deep_counts.leaf_bytes_per_fit(
                shape["n"], shape["stages"], shape["depth"])

    def reference(self, work=torch.float32, acc=torch.float64) -> dict:
        """The level-wise reference's fit of the same rows (``work`` and
        ``acc`` its precisions), as a forest ``forest_scores`` reads."""
        cfg, depth = self.config, self.cell["max_depth"]
        ref = gbdt_deep.fit(self.X, self.y, n_estimators=cfg["n_estimators"],
                            learning_rate=cfg["learning_rate"], max_depth=depth,
                            n_bins=cfg["n_bins"], work=work, acc=acc)
        left, right = reference.heap_children(ref["split"])
        ref.update(left=left, right=right, depth=depth)
        return ref

    def gaps(self, ref: dict, forest: dict, deviance) -> dict:
        """``dev_gap`` and ``forest_dev_gap`` of one forest and deviance
        path against the reference's."""
        want = ref["deviance"]
        path = torch.as_tensor(deviance).double().cpu()
        r = reference.forest_scores(self.X, forest)
        final = -2.0 * torch.mean(self.y.double() * r - torch.logaddexp(torch.zeros_like(r), r))
        out = {"dev_gap": float(((path - want).abs() / want.abs()).max()),
               "forest_dev_gap": abs(float(final) - float(want[-1])) / abs(float(want[-1]))}
        return {k: v if math.isfinite(v) else math.inf for k, v in out.items()}

    def check(self) -> tuple[dict, int]:
        if self._ref is None:
            self._ref = self.reference()
        limits = self.cell["limits"]
        worst, failed = dict.fromkeys(limits, 0.0), 0
        for params, deviance in self.fits:
            gaps = self.gaps(self._ref, self.program_forest(params), deviance)
            failed += not all(gaps[k] <= limits[k] for k in limits)
            worst = {k: max(worst[k], gaps[k]) for k in limits}
        return {k: (worst[k], limits[k]) for k in limits}, failed

    def control(self) -> dict:
        """The check's numbers for the reference one precision down."""
        if self._ref is None:
            self._ref = self.reference()
        ctl = self.reference(work=torch.bfloat16, acc=torch.float32)
        return self.gaps(self._ref, ctl, ctl["deviance"])


def shallow():
    """A fit that grows ``SHALLOW_DEPTH`` levels where the cell asks for
    more: its forest is checked at the cell's depth (its leaves loop on
    themselves), so only the missing levels differ."""
    def make(fit):
        def broken(X, y, cfg, **kw):
            return fit(X, y, dataclasses.replace(cfg, max_depth=min(cfg.max_depth, SHALLOW_DEPTH)),
                       **kw)
        return broken

    return gbdt_fit._patched_fit(make)


FAULTS = {**gbdt_fit.FAULTS, "shallow": shallow}


def setup(config: dict, cell: dict, seed: int, dev: torch.device) -> GBDTDeepFit:
    return GBDTDeepFit(config, cell, seed, dev)
