"""The output check decides ``correct``: a sound run at a small size passes
it; the same run with each fault of its job module's ``FAULTS`` planted
under the timed path, and the control (the reference in the precision below the
configuration's, in the program's place), fail it. The harness's look for a
card is skipped: the runs are on the CPU. One test runs a small traced cell
on the card."""

from __future__ import annotations

import math

import pytest
import torch

from hfbench import harness

SMALL = {
    "gbdt_10m.fit_stumps": {"n_rows": 120_000, "n_estimators": 6},
    "gbdt_10m.fit_depth3": {"n_rows": 120_000, "n_estimators": 3},
    "hf_pipeline.engine_b512": {"pool_batches": 3, "warm_calls": 1},
}
CELL_FAULTS = [("gbdt_10m.fit_stumps", "unchanged"), ("gbdt_10m.fit_stumps", "half_rows"),
               ("gbdt_10m.fit_depth3", "unchanged"), ("gbdt_10m.fit_depth3", "half_rows"),
               ("hf_pipeline.engine_b512", "altered_answer")]


def job_module(cell: str):
    r = harness.resolve(harness.manifest(), cell)
    return harness.load_module(r["job_path"], f"t_{r['config']['job']}")


def run(cell: str, seed: int = 2**31 + 3, device="cpu", trace_on=False) -> dict:
    return harness.run_cell(cell, seed, 0.05, trace_on, device=device, overrides=SMALL[cell])


@pytest.mark.parametrize("cell", list(SMALL))
def test_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert all(math.isfinite(m["value"]) and m["value"] > 0 for m in r["metrics"].values())
    line = harness.result_line(r)
    assert line.index('"checks"') > line.index('"device"')


@pytest.mark.parametrize("cell,fault", CELL_FAULTS)
def test_planted_fault_is_not_correct(cell, fault):
    with job_module(cell).FAULTS[fault]():
        r = run(cell)
    assert not r["correct"], r["checks"]
    assert r["failed"] == r["attempted"]


def test_every_fault_of_a_job_is_planted_in_a_cell():
    for cell in SMALL:
        assert {f for c, f in CELL_FAULTS if c == cell} == set(job_module(cell).FAULTS)


@pytest.mark.parametrize("cell", list(SMALL))
def test_control_fails_the_check(cell):
    r = harness.resolve(harness.manifest(), cell)
    config, cellfile = dict(r["config"]), dict(r["cell"])
    for key, value in SMALL[cell].items():
        (cellfile if key in cellfile else config)[key] = value
    job = job_module(cell).setup(config, cellfile, 11, torch.device("cpu"))
    numbers = job.control()
    assert set(numbers) == set(cellfile["limits"])
    assert any(numbers[k] > cellfile["limits"][k] for k in numbers), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(SMALL))
def test_traced_small_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = run(cell, device="cuda", trace_on=True)
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0 and r["device"]["window_s"] > 0
    assert r["metrics"], "the traced run reports its per-layer metrics"
    for name, m in r["metrics"].items():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 100, name
