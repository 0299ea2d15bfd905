"""Driver of ``serve.engine.BucketedPredictEngine.predict``: one caller in a
closed loop, as a replica's batcher flush thread calls the engine.

Set-up draws the pipeline's weights and a pool of distinct contract batches
on the device from the seed, builds the program's parameter objects from
them, builds the engine on the cell's one bucket (``quality=None``), warms
it (the capture and the engine's own check against its eager route) and
makes a few untimed calls. Each timed call scores the next batch of the
pool (host rows in, probabilities on the host out) and keeps its answer.
``rows_per_s`` is every row scored over the window's time.

The check scores every batch of the pool with the plain reference (float64)
once the window has closed, and holds every answer of the window to it:
``p1_gap``, the largest absolute difference of P(class 1). The reference
is computed once per job.

``control()`` gives that number for the float32 reference in the program's
place; ``FAULTS`` are the faults a served batch can have, planted under the
timed path by ``hfbench.calibrate`` and the tests.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from hfbench.counts import pipeline as counts
from hfbench.counts.peaks import peaks_for
from hfbench.gen import pipeline as gen
from hfbench.reference import pipeline as reference


def program_params(w: dict, width: int):
    """The program's ``PipelineParams`` built from the weights dict."""
    from machine_learning_replications_tpu_torch.models import (
        knn_impute, linear, pipeline, scaler, stacking, svm, tree,
    )

    dev = w["donors"].device
    mask = torch.zeros(width, dtype=torch.bool, device=dev)
    mask[w["support"]] = True
    T = w["stump_feature"].shape[0]
    inf = torch.full((T,), torch.inf, dtype=torch.float64, device=dev)
    zero = torch.zeros(T, dtype=torch.float64, device=dev)
    gbdt = tree.TreeEnsembleParams(
        feature=torch.stack([w["stump_feature"], 0 * w["stump_feature"],
                             0 * w["stump_feature"]], 1).to(torch.int32),
        threshold=torch.stack([w["stump_threshold"], inf, inf], 1),
        left=torch.tensor([[1, 1, 2]], dtype=torch.int32, device=dev).repeat(T, 1),
        right=torch.tensor([[2, 1, 2]], dtype=torch.int32, device=dev).repeat(T, 1),
        value=torch.stack([zero, w["stump_left"], w["stump_right"]], 1),
        init_raw=w["gbdt_init"], learning_rate=w["gbdt_lr"], max_depth=1)
    ensemble = stacking.StackingParams(
        scaler=scaler.ScalerParams(mean=w["scaler_mean"], scale=w["scaler_scale"]),
        svc=svm.SVCParams(support_vectors=w["sv"], dual_coef=w["dual_coef"],
                          intercept=w["svc_intercept"], gamma=w["gamma"],
                          prob_a=w["prob_a"], prob_b=w["prob_b"]),
        gbdt=gbdt,
        logreg=linear.LinearParams(coef=w["lr_coef"], intercept=w["lr_intercept"]),
        meta=linear.LinearParams(coef=w["meta_coef"], intercept=w["meta_intercept"]))
    return pipeline.PipelineParams(
        imputer=knn_impute.KNNImputerParams(donors=w["donors"], col_means=w["col_means"]),
        support_mask=mask, ensemble=ensemble)


class EnginePredict:
    unit = "batch"

    def __init__(self, config: dict, cell: dict, seed: int, dev: torch.device):
        from machine_learning_replications_tpu_torch.serve.engine import BucketedPredictEngine

        self.config, self.cell, self.dev = config, cell, dev
        self.w = gen.weights(config, seed, dev)
        self.rows = cell["bucket"]
        self.pool = gen.contract_batches(config, cell["pool_batches"], self.rows, seed, dev)
        self.host_pool = self.pool.cpu().numpy()
        self.width = self.w["donors"].shape[1]
        self.engine = BucketedPredictEngine(program_params(self.w, self.width),
                                            buckets=(self.rows,), quality=None, device=dev)
        self.engine.warmup()
        self.calibration_calls = 2 * len(self.host_pool)
        self._ref = None
        self.answers: list = []
        for i in range(cell["warm_calls"]):
            self.call(i)

    def call(self, i: int) -> None:
        if i == 0:
            self.answers.clear()
        k = i % len(self.host_pool)
        self.answers.append((k, self.engine.predict(self.host_pool[k])))

    def end_to_end(self, t_start: float, marks: list) -> dict:
        return {"rows_per_s": self.rows * len(marks) / (marks[-1][1] - t_start)}

    def shape(self) -> dict:
        w = self.w
        donor_nan = torch.isnan(w["donors"]).any(0)
        present = torch.zeros_like(donor_nan)
        present[w["selected"]] = True
        return dict(present=int(present.sum()), donors=w["donors"].shape[0],
                    masked=int((donor_nan & ~present).sum()), sv=w["sv"].shape[0],
                    F=w["support"].shape[0], trees=w["stump_feature"].shape[0],
                    iters=reference.COUPLING_ITERS, width=self.width)

    def trace_extras(self, summary: dict) -> None:
        peaks = peaks_for(torch.cuda.get_device_name(self.dev))
        summary["least_s_per_call"] = counts.batch_least(self.rows, peaks,
                                                         **self.shape())["seconds"]

    def release(self) -> None:
        self.engine = None

    def reference_p1(self, dtype=torch.float64) -> np.ndarray:
        """``[pool, rows]`` reference P(class 1), one batch at a time."""
        return np.stack([reference.predict_p1(self.w, b, dtype).double().cpu().numpy()
                         for b in self.pool])

    def gaps(self, ref: np.ndarray) -> list[float]:
        out = []
        for k, p in self.answers:
            g = float(np.max(np.abs(np.asarray(p, np.float64) - ref[k])))
            out.append(g if math.isfinite(g) else math.inf)
        return out

    def _reference(self) -> np.ndarray:
        if self._ref is None:
            self._ref = self.reference_p1()
        return self._ref

    def check(self) -> tuple[dict, int]:
        limit = self.cell["limits"]["p1_gap"]
        gaps = self.gaps(self._reference())
        return {"p1_gap": (max(gaps), limit)}, sum(g > limit for g in gaps)

    def control(self) -> dict:
        """The check's number for the float32 reference."""
        return {"p1_gap": float(np.max(np.abs(self.reference_p1(torch.float32)
                                              - self._reference())))}


@contextlib.contextmanager
def altered_answer():
    """A served batch whose first probability is replaced by its
    complement."""
    from machine_learning_replications_tpu_torch.serve.engine import BucketedPredictEngine

    predict = BucketedPredictEngine.predict

    def broken(self, X):
        p = predict(self, X).copy()
        p[0] = 1.0 - p[0]
        return p

    BucketedPredictEngine.predict = broken
    try:
        yield
    finally:
        BucketedPredictEngine.predict = predict


FAULTS = {"altered_answer": altered_answer}


def setup(config: dict, cell: dict, seed: int, dev: torch.device) -> EnginePredict:
    return EnginePredict(config, cell, seed, dev)
