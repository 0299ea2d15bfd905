"""The HIGGS depth-8 cell (``higgs_10m.fit_depth8``) at a small size: its
cohort spec, its output check on a sound run, under each fault of its job
module and for its control; one test runs a small traced run on the card.
The runs on the CPU skip the harness's look for a card."""

from __future__ import annotations

import math

import pytest
import torch

from hfbench import harness
from hfbench.gen import cohort

CELL = "higgs_10m.fit_depth8"
SMALL = {"n_rows": 120_000, "n_estimators": 3}
B_TAGS = ("jet_1_b-tag", "jet_2_b-tag", "jet_3_b-tag", "jet_4_b-tag")
MASSES = ("m_jj", "m_jjj", "m_lv", "m_jlv", "m_bb", "m_wbb", "m_wwbb")


def job_module():
    r = harness.resolve(harness.manifest(), CELL)
    return harness.load_module(r["job_path"], f"t_{r['config']['job']}")


def run(seed: int = 2**31 + 23, device="cpu", trace_on=False) -> dict:
    return harness.run_cell(CELL, seed, 0.05, trace_on, device=device, overrides=SMALL)


def test_spec_columns_match_their_kinds():
    sp = cohort.spec("higgs")
    names = [c["name"] for c in sp["columns"]]
    assert len(names) == 28 and sp["selected"] == names
    assert len(sp["outcome_coef"]) == 28 and sp["positive_rate"] == 0.53
    kinds = {c["name"]: c["kind"] for c in sp["columns"]}
    assert {n for n, k in kinds.items() if k == "ordinal"} == set(B_TAGS)
    assert sum(k == "continuous" for k in kinds.values()) == 24
    for c in sp["columns"]:
        if c["kind"] == "continuous":      # the clamp at 0 never binds, no zero inflation
            assert c["mean"] / c["sd"] >= 9.999 and c["median"] == c["mean"]
    coef = dict(zip(names, sp["outcome_coef"]))
    assert min(coef[m] for m in MASSES) > max(coef[n] for n in names if n not in MASSES)
    X, y = cohort.gbdt_cohort(50_000, 2**31 + 24, torch.device("cpu"), spec_name="higgs")
    assert X.shape == (50_000, 28) and X.dtype == torch.float32
    assert abs(float(y.mean()) - 0.53) < 0.02
    for j, name in enumerate(names):
        levels = torch.unique(X[:, j])
        if name in B_TAGS:
            assert levels.tolist() == [0.0, 1.0, 2.0]
        else:
            assert levels.numel() > 40_000 and float(levels[0]) > 0


def test_sound_run_is_correct():
    r = run()
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"setup_s", "fit_s"}
    assert all(math.isfinite(m["value"]) and m["value"] > 0 for m in r["metrics"].values())


@pytest.mark.parametrize("fault", ["unchanged", "half_rows", "shallow"])
def test_planted_fault_is_not_correct(fault):
    with job_module().FAULTS[fault]():
        r = run()
    assert not r["correct"], r["checks"]
    assert r["failed"] == r["attempted"]


def test_the_job_has_the_fit_faults_and_shallow():
    assert set(job_module().FAULTS) == {"unchanged", "half_rows", "shallow"}


def test_control_fails_the_check():
    r = harness.resolve(harness.manifest(), CELL)
    config, cell = dict(r["config"], **SMALL), dict(r["cell"])
    job = job_module().setup(config, cell, 11, torch.device("cpu"))
    numbers = job.control()
    assert set(numbers) == set(cell["limits"])
    assert any(numbers[k] > cell["limits"][k] for k in numbers), numbers


@pytest.mark.cuda
def test_traced_small_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = run(device="cuda", trace_on=True)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    assert m["kernel.node_row_passes"]["value"] == pytest.approx(186 / 8)
    for name in ("fit.kernels_per_fit", "kernel.node_roofline", "kernel.leaf_sums_roofline",
                 "mfu.fit", "idle_share.fit"):
        assert name in m, name
    for name, v in m.items():
        if v["unit"] == "%":
            assert 0 <= v["value"] <= 100, name
