"""The plain references agree with the program on the CPU at small sizes.

The 'hist' fits take the program's device-binning path from 100,000 rows
(``gbdt.DEVICE_BINNING_MIN_ROWS``), so the fit cases run at 120,000 rows and
a few stages."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hfbench import harness
from hfbench.gen import cohort
from hfbench.gen import pipeline as gen
from hfbench.jobs import engine_predict
from hfbench.reference import gbdt as ref_gbdt
from hfbench.reference import pipeline as ref_pipeline
from machine_learning_replications_tpu_torch.config import GBDTConfig
from machine_learning_replications_tpu_torch.models import gbdt, pipeline

CPU = torch.device("cpu")
PIPE = harness.load_json(harness.PACKAGE / "configs" / "hf_pipeline.json")


def test_cohort_is_seeded_and_matches_the_schema():
    X, y = cohort.gbdt_cohort(20_000, 2**31 + 5, CPU)
    X2, y2 = cohort.gbdt_cohort(20_000, 2**31 + 5, CPU)
    assert torch.equal(X, X2) and torch.equal(y, y2)
    assert not torch.equal(X, cohort.gbdt_cohort(20_000, 2**31 + 6, CPU)[0])
    assert X.dtype == torch.float32 and X.shape == (20_000, 17)
    assert abs(float(y.mean()) - 0.19776) < 0.02
    sp = cohort.spec()
    for j, c in enumerate(cohort.selected_columns(sp)):
        col = sp["columns"][c]
        if col["kind"] == "binary":
            assert abs(float(X[:, j].mean()) - col["p"]) < 0.02


@pytest.mark.parametrize("depth", [1, 3])
def test_gbdt_reference_agrees_with_the_program(depth):
    X, y = cohort.gbdt_cohort(120_000, 77, CPU)
    cfg = GBDTConfig(n_estimators=4, max_depth=depth, splitter="hist", n_bins=256)
    params, aux = gbdt.fit(X, y, cfg, device="cpu")
    ref = ref_gbdt.fit(X, y, n_estimators=4, learning_rate=0.1, max_depth=depth, n_bins=256)
    left, right = ref_gbdt.heap_children(ref["split"])
    want = ref_gbdt.forest_scores(X, dict(ref, left=left, right=right, depth=depth))
    got = ref_gbdt.forest_scores(X, {
        "feature": params.feature, "threshold": params.threshold, "left": params.left,
        "right": params.right, "value": params.value, "init": float(params.init_raw),
        "learning_rate": 0.1, "depth": depth})
    assert float((got - want).abs().max()) < 1e-5
    assert torch.equal(params.feature[:, 0].long(), ref["feature"][:, 0])
    dev = torch.as_tensor(aux["train_deviance"]).double()
    assert float(((dev - ref["deviance"]).abs() / ref["deviance"]).max()) < 1e-6
    assert torch.allclose(ref["raw"], want, atol=1e-5)


def test_binning_matches_the_program():
    from machine_learning_replications_tpu_torch.ops import binning

    X, _ = cohort.gbdt_cohort(120_000, 78, CPU)
    bins, thr = ref_gbdt.bin_columns(X, 256)
    got, mids, _ = binning.device_binning_core(X, 256)
    assert torch.equal(bins, got.long())
    assert torch.equal(thr, mids.T)


@pytest.mark.parametrize("support", ["selected", "with_imputed_columns"])
def test_pipeline_reference_agrees_with_the_program(support):
    w = gen.weights(PIPE, 2**31 + 9, CPU)
    if support == "with_imputed_columns":
        # a support that reads columns the contract does not carry, so the
        # imputer's values reach the output
        w["support"] = torch.tensor(sorted(range(40, 57)), dtype=torch.long)
    rows = gen.contract_batches(PIPE, 2, 64, 2**31 + 9, CPU).reshape(-1, 17)
    params = engine_predict.program_params(w, 64)
    got = pipeline.pipeline_predict_proba1_contract(params, rows.numpy(), device="cpu")
    want = ref_pipeline.predict_p1(w, rows)
    assert float((got.double() - want).abs().max()) < 1e-12
    low = ref_pipeline.predict_p1(w, rows, torch.float32).double()
    assert float((low - want).abs().max()) > 1e-9


def test_coupling_is_libsvms():
    r0 = torch.tensor([1e-7, 0.2, 0.5, 0.73, 1 - 1e-7], dtype=torch.float64)
    p = ref_pipeline.coupling_p1(r0).numpy()
    assert np.all((p > 0) & (p < 1))
    assert np.allclose(p, 1 - r0.numpy(), atol=3e-3)        # the coupling's tolerance
    assert p[2] == pytest.approx(0.5)
