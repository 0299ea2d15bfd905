"""Copy drift between the JAX package's jax-free modules (serving, bulk
scoring, continual learning's capture and trigger, the fleet) and the
port's copies of them.

The port imports nothing of the JAX package, so it keeps its own copy of
each jax-free module serving needs. A verbatim copy must stay equal to its
original once the package name is rewritten; a merged module
(``obs/quality.py``, whose ``build_reference_profile`` is the port's own)
is held by the outputs of the copied functions instead. A later edit to
either side then fails here, loudly, instead of drifting.
"""

from pathlib import Path

import numpy as np
import pytest

from machine_learning_replications_tpu.obs import quality as jquality
from machine_learning_replications_tpu.obs.registry import MetricsRegistry as JRegistry
from machine_learning_replications_tpu_torch.obs import quality
from machine_learning_replications_tpu_torch.obs.registry import MetricsRegistry

REPO = Path(__file__).resolve().parents[1]
VERBATIM = (
    "contracts.py",
    "serve/protocol.py",
    "serve/transport.py",
    "resilience/__init__.py",
    "resilience/faults.py",
    "resilience/supervisor.py",
    "obs/reqtrace.py",
    "obs/slo.py",
    "obs/timeseries.py",
    "obs/alerts.py",
    "obs/incident.py",
    "lazyimport.py",
    "score/progress.py",
    "score/writer.py",
    "score/reader.py",
    "learn/capture.py",
    "learn/trigger.py",
    "fleet/__init__.py",
    "fleet/health.py",
    "fleet/registry.py",
    "fleet/router.py",
    "fleet/deploy.py",
    "fleet/lifecycle.py",
    "fleet/autoscale.py",
    "obs/fleetmetrics.py",
    "obs/fleettrace.py",
)
#: The one line a copy may differ in: the replica launcher runs this
#: package's ``serve`` (the rename rewrites only ``…_tpu.`` with a dot).
ALLOWED = {
    "fleet/lifecycle.py": (
        'self.python, "-m", "machine_learning_replications_tpu",',
        'self.python, "-m", "machine_learning_replications_tpu_torch",',
    ),
}


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_equals_its_original(rel):
    original = (REPO / "machine_learning_replications_tpu" / rel).read_text()
    copy = (REPO / "machine_learning_replications_tpu_torch" / rel).read_text()
    renamed = original.replace("machine_learning_replications_tpu.",
                               "machine_learning_replications_tpu_torch.")
    if rel in ALLOWED:
        jax_line, port_line = ALLOWED[rel]
        assert renamed.count(jax_line) == 1 and copy.count(port_line) == 1
        renamed = renamed.replace(jax_line, port_line)
    assert copy == renamed, f"{rel} drifted from the JAX package's copy"


def _profile_and_batches(seed=3, F=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(400, F))
    X[:, 0] = (X[:, 0] > 0.2).astype(float)
    scores = 1.0 / (1.0 + np.exp(-X @ rng.normal(size=F)))
    y = (rng.random(400) < scores).astype(float)
    prof = quality.build_reference_profile(X, scores, y)
    batches = []
    for k in range(6):        # drifting: the later batches shift feature 1
        Xb = rng.normal(size=(64, F))
        Xb[:, 1] += 0.4 * k
        pb = 1.0 / (1.0 + np.exp(-Xb @ rng.normal(size=F)))
        mb = np.clip(pb[:, None] + 0.05 * rng.normal(size=(64, 3)), 0, 1)
        batches.append((Xb, pb, mb))
    return prof, batches


@pytest.mark.parametrize("name", ["psi", "ks_binned"])
def test_quality_statistics_equal_jax(name):
    rng = np.random.default_rng(7)
    for _ in range(5):
        e, a = rng.integers(0, 50, 10).astype(float) + 1, rng.integers(0, 50, 10).astype(float)
        a[0] += 1
        assert getattr(quality, name)(e, a) == getattr(jquality, name)(e, a)


def test_quality_helpers_equal_jax():
    prof, batches = _profile_and_batches()
    for got, want in zip(quality.profile_bin_geometry(prof), jquality.profile_bin_geometry(prof)):
        np.testing.assert_array_equal(got, want)
    m = batches[0][2]
    np.testing.assert_array_equal(quality.pairwise_disagreement(m), jquality.pairwise_disagreement(m))
    assert quality.disabled_snapshot("off") == jquality.disabled_snapshot("off")
    for k in ("DEFAULT_WARN_PSI", "DEFAULT_ALERT_PSI", "PROFILE_VERSION", "DEFAULT_FEATURE_BINS",
              "DEFAULT_SCORE_BINS", "PROFILE_QUANTILES", "TRANSITION_HISTORY"):
        assert getattr(quality, k) == getattr(jquality, k), k


def _strip_times(snap):
    """Snapshots stamp wall-clock times; everything else must be equal."""
    if isinstance(snap, dict):
        return {k: _strip_times(v) for k, v in snap.items()
                if k not in ("updated_unix", "at_unix", "t", "ts", "since_unix")}
    if isinstance(snap, list):
        return [_strip_times(v) for v in snap]
    return snap


@pytest.mark.parametrize("detail", [False, True])
def test_quality_monitor_snapshots_equal_jax(detail):
    prof, batches = _profile_and_batches()
    names = [f"f{i}" for i in range(5)]
    mon = quality.QualityMonitor(prof, registry=MetricsRegistry(), min_rows=50, window=256,
                                 feature_names=names)
    jmon = jquality.QualityMonitor(prof, registry=JRegistry(), min_rows=50, window=256,
                                   feature_names=names)
    for Xb, pb, mb in batches:
        mon.observe_batch(Xb, pb, mb)
        jmon.observe_batch(Xb, pb, mb)
    got, want = mon.snapshot(detail=detail), jmon.snapshot(detail=detail)
    assert _strip_times(got) == _strip_times(want)
    assert mon.health() == jmon.health()


def test_quality_profile_of_tensors_is_read_as_numpy():
    import torch

    prof, batches = _profile_and_batches()
    tprof = {k: torch.as_tensor(v) for k, v in prof.items()}
    mon = quality.QualityMonitor(tprof, registry=MetricsRegistry(), min_rows=50, window=256)
    ref = quality.QualityMonitor(prof, registry=MetricsRegistry(), min_rows=50, window=256)
    for Xb, pb, mb in batches:
        mon.observe_batch(Xb, pb, mb)
        ref.observe_batch(Xb, pb, mb)
    assert _strip_times(mon.snapshot(detail=True)) == _strip_times(ref.snapshot(detail=True))


def test_async_feed_delivers_like_jax():
    prof, batches = _profile_and_batches()
    out = {}
    for name, mod, reg in (("port", quality, MetricsRegistry), ("jax", jquality, JRegistry)):
        mon = mod.QualityMonitor(prof, registry=reg(), min_rows=50, window=256)
        feed = mod.AsyncQualityFeed(mon)
        for Xb, pb, mb in batches:
            feed.observe_batch(Xb, pb, mb)
        feed.drain(timeout=10.0)
        feed.close()
        out[name] = _strip_times(mon.snapshot(detail=True))
    assert out["port"] == out["jax"]
