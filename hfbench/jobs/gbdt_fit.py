"""Driver of ``models.gbdt.fit``: whole fits back to back on one resident
cohort.

Set-up draws the cohort on the device from the seed (``X [n, 17]`` float32
and its labels), then runs a fit of ``WARM_STAGES`` stages untimed, at the
cell's depth on the same rows, which builds or loads the hand kernel and
warms every shape a fit uses. Each timed call is one ``gbdt.fit`` of the
configuration at the cell's ``max_depth``, ended by a device sync; its
forest and deviance path are kept. ``fit_s`` is the window's time, from its
start to the end of its last fit, over the fits.

The check refits the same rows with the plain reference (float64 sums)
once the window has closed and holds every fit of the window to it:
``raw_gap``, the largest difference of the two forests' raw scores over all
training rows, and ``dev_gap``, the largest relative difference of the two
deviance paths over the stages. The reference is fitted once per job.

``control()`` gives the same numbers for the reference in the precision
below the configuration's (bfloat16 scores, float32 sums) in the program's
place; ``FAULTS`` are the faults a fit can have, planted under the timed
path by ``hfbench.calibrate`` and the tests.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from hfbench.counts import gbdt as counts
from hfbench.counts.peaks import peaks_for
from hfbench.gen import cohort
from hfbench.reference import gbdt as reference


WARM_STAGES = 2


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class GBDTFit:
    unit = "fit"
    calibration_calls = 1

    def __init__(self, config: dict, cell: dict, seed: int, dev: torch.device):
        from machine_learning_replications_tpu_torch.config import GBDTConfig

        self.config, self.cell, self.dev = config, cell, dev
        self.X, self.y = cohort.gbdt_cohort(config["n_rows"], seed, dev,
                                            spec_name=config["cohort"])
        self.gcfg = GBDTConfig(
            n_estimators=config["n_estimators"], max_depth=cell["max_depth"],
            learning_rate=config["learning_rate"], splitter=config["splitter"],
            n_bins=config["n_bins"], min_samples_split=config["min_samples_split"],
            min_samples_leaf=config["min_samples_leaf"])
        self.fits: list = []
        self._ref = None
        self._fit(dataclasses.replace(self.gcfg, n_estimators=WARM_STAGES))
        self.fits.clear()
        self._launches0 = None

    def _fit(self, gcfg):
        from machine_learning_replications_tpu_torch.models import gbdt

        params, aux = gbdt.fit(self.X, self.y, gcfg, device=self.dev)
        _sync(self.dev)
        self.fits.append((params, aux["train_deviance"]))

    def call(self, i: int) -> None:
        if i == 0:
            self.fits.clear()
            self._launches0 = self._launch_counts()
        self._fit(self.gcfg)

    @staticmethod
    def _launch_counts() -> dict:
        from machine_learning_replications_tpu_torch.ops import cuda_histogram

        return dict(cuda_histogram.LAUNCHES)

    def end_to_end(self, t_start: float, marks: list) -> dict:
        return {"fit_s": (marks[-1][1] - t_start) / len(marks)}

    def _shape(self) -> dict:
        n, F = self.X.shape
        return dict(n=n, F=F, B=self.config["n_bins"], stages=self.config["n_estimators"],
                    depth=self.cell["max_depth"])

    def trace_extras(self, summary: dict) -> None:
        name = torch.cuda.get_device_name(self.dev)
        shape = self._shape()
        after = self._launch_counts()
        launches = {k: after[k] - self._launches0.get(k, 0) for k in after}
        want = counts.launches_per_fit(shape["stages"], shape["depth"])
        fits = summary["calls"]
        summary["launches"] = launches
        summary["least_s_per_call"] = counts.fit_least(peaks=peaks_for(name), **shape)["seconds"]
        summary["bytes_per_s"] = peaks_for(name)["bytes"]
        if all(launches.get(k, 0) == v * fits for k, v in want.items()):
            summary["hand_kernel_bytes"] = fits * counts.kernel_bytes_per_fit(**shape)

    def release(self) -> None:
        pass

    def reference(self, work=torch.float32, acc=torch.float64) -> dict:
        """The plain reference's fit of the same rows (``work`` and ``acc``
        its precisions), with its forest's raw scores on them."""
        cfg, depth = self.config, self.cell["max_depth"]
        ref = reference.fit(self.X, self.y, n_estimators=cfg["n_estimators"],
                            learning_rate=cfg["learning_rate"], max_depth=depth,
                            n_bins=cfg["n_bins"], work=work, acc=acc)
        left, right = reference.heap_children(ref["split"])
        ref.update(left=left, right=right, depth=depth)
        ref["scores"] = reference.forest_scores(self.X, ref)
        return ref

    def gaps(self, ref: dict, forest: dict, deviance) -> tuple[float, float]:
        """``(raw_gap, dev_gap)`` of one forest and deviance path."""
        r = float((reference.forest_scores(self.X, forest) - ref["scores"]).abs().max())
        d = float(((torch.as_tensor(deviance).double().cpu() - ref["deviance"]).abs()
                   / ref["deviance"].abs()).max())
        return tuple(x if math.isfinite(x) else math.inf for x in (r, d))

    def program_forest(self, params) -> dict:
        return {"feature": params.feature, "threshold": params.threshold,
                "left": params.left, "right": params.right, "value": params.value,
                "init": float(params.init_raw), "learning_rate": float(params.learning_rate),
                "depth": self.cell["max_depth"]}

    def check(self) -> tuple[dict, int]:
        if self._ref is None:
            self._ref = self.reference()
        ref = self._ref
        limits = self.cell["limits"]
        raw_gap = dev_gap = 0.0
        failed = 0
        for params, deviance in self.fits:
            r, d = self.gaps(ref, self.program_forest(params), deviance)
            failed += not (r <= limits["raw_gap"] and d <= limits["dev_gap"])
            raw_gap, dev_gap = max(raw_gap, r), max(dev_gap, d)
        return {"raw_gap": (raw_gap, limits["raw_gap"]),
                "dev_gap": (dev_gap, limits["dev_gap"])}, failed


    def control(self) -> dict:
        """The check's numbers for the reference one precision down."""
        if self._ref is None:
            self._ref = self.reference()
        ctl = self.reference(work=torch.bfloat16, acc=torch.float32)
        raw_gap, dev_gap = self.gaps(self._ref, ctl, ctl["deviance"])
        return {"raw_gap": raw_gap, "dev_gap": dev_gap}


@contextlib.contextmanager
def _patched_fit(make):
    from machine_learning_replications_tpu_torch.models import gbdt

    original = gbdt.fit
    gbdt.fit = make(original)
    try:
        yield
    finally:
        gbdt.fit = original


def unchanged():
    """A fit whose stages leave the scores as they were: every leaf 0, the
    deviance path flat at the prior's."""
    def make(fit):
        def broken(X, y, cfg, **kw):
            params, aux = fit(X, y, cfg, **kw)
            p1, f0 = float(torch.as_tensor(y).double().mean()), float(params.init_raw)
            dev0 = -2.0 * (p1 * f0 - math.log1p(math.exp(f0)))
            flat = torch.full((cfg.n_estimators,), dev0, dtype=torch.float64)
            return dataclasses.replace(params, value=torch.zeros_like(params.value)), {
                "train_deviance": flat}
        return broken

    return _patched_fit(make)


def half_rows():
    """A fit that leaves out every other row."""
    def make(fit):
        def broken(X, y, cfg, **kw):
            return fit(X[::2].contiguous(), y[::2].contiguous(), cfg, **kw)
        return broken

    return _patched_fit(make)


FAULTS = {"unchanged": unchanged, "half_rows": half_rows}


def setup(config: dict, cell: dict, seed: int, dev: torch.device) -> GBDTFit:
    return GBDTFit(config, cell, seed, dev)
