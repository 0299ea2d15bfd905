"""Aggregated fleet metrics: scrape in-rotation replicas, merge families.

Per-replica ``/metrics`` pages answer "how is replica rN doing"; capacity
planning and SLO accounting need the *service* view — one page where
``serve_requests_total`` is the fleet's throughput, not one process's.
This module is the router's control-plane aggregation layer behind
``GET /fleet/metrics``:

  * ``FleetScraper`` GETs every in-rotation replica's ``/metrics``
    (bounded per-replica timeout). A stale/unreachable replica is
    **marked, never silently omitted**: ``fleet_scrape_stale{replica=…}``
    flips to 1, the transition is journaled
    (``fleet_scrape_transition``), and the scrape result lands on
    ``fleet_scrape_total{result=…}`` — an aggregated page missing a
    replica must say so on the page itself.
  * ``merge_expositions`` folds the parsed pages into one
    strict-validator-clean exposition with the standard aggregation
    semantics per kind: **counters sum** across replicas (per label
    set), **gauges re-emit** with a ``replica`` label appended (a mean
    of queue depths is a lie; per-replica series are the truth), and
    **histograms bucket-merge** — identical ``le`` boundaries required,
    cumulative bucket counts / ``_sum`` / ``_count`` summed per label
    set. A family that cannot merge honestly (bucket boundaries differ
    across replicas mid-deploy, kinds disagree, label keys disagree) is
    dropped from the page and counted on
    ``fleet_scrape_merge_rejected_total{reason=…}`` — rejection is
    observable, not silent.
  * Families the router process itself owns (``fleet_*``,
    ``reqtrace_*``, …) are reported from the router's own registry and
    the replica-side copies are dropped from the merge
    (``reason="router_owned"``): one page, one writer per family name,
    no duplicate-family validator errors.
  * ``SLOTracker`` over the **router's own request stream** (the
    ``fleet_slo_*`` families, fed from the data path's single exit) —
    error-budget burn accounted where clients experience it, not
    per-replica. Client-fault 4xx outcomes are excluded, the same
    convention the replica-side tracker uses.

No jax anywhere (the router's import-purity rule covers this module
transitively); the parser is stdlib-only and strict enough for the pages
our own stack renders — it is a merge frontend, not a general scraper.
"""

from __future__ import annotations

import threading
import urllib.request

from machine_learning_replications_tpu_torch.obs import journal
from machine_learning_replications_tpu_torch.obs.registry import (
    REGISTRY,
    MetricsRegistry,
    _escape_label_value,
)
from machine_learning_replications_tpu_torch.obs.slo import (
    SLO,
    SLOTracker,
    default_slos,
)

FLEET_SCRAPES = REGISTRY.counter(
    "fleet_scrape_total",
    "Per-replica /metrics scrapes behind /fleet/metrics by result.",
    labels=("result",),
)
FLEET_SCRAPE_STALE = REGISTRY.gauge(
    "fleet_scrape_stale",
    "1 when the replica's last /metrics scrape failed or timed out (its "
    "series on the aggregated page are stale or absent), else 0.",
    labels=("replica",),
)
FLEET_MERGE_REJECTED = REGISTRY.counter(
    "fleet_scrape_merge_rejected_total",
    "Replica metric families dropped from the aggregated page by reason "
    "(bucket_mismatch, kind_mismatch, label_mismatch, unsupported, "
    "router_owned).",
    labels=("reason",),
)
for _result in ("ok", "error"):
    FLEET_SCRAPES.labels(result=_result)

# The fleet-level SLO families: same shape as the per-process slo_*
# set (obs.slo), distinct names so a fleet page can carry BOTH the
# router-accounted fleet burn and the merged per-replica burn gauges.
FLEET_SLO_REQUESTS = REGISTRY.counter(
    "fleet_slo_requests_total",
    "Routed requests evaluated against the fleet-level SLO.",
    labels=("slo",),
)
FLEET_SLO_BAD = REGISTRY.counter(
    "fleet_slo_bad_total",
    "Routed requests that violated the fleet-level SLO.",
    labels=("slo",),
)
FLEET_SLO_GOOD = REGISTRY.gauge(
    "fleet_slo_good_ratio",
    "Fleet-level good-event ratio over the recent request window.",
    labels=("slo",),
)
FLEET_SLO_BURN = REGISTRY.gauge(
    "fleet_slo_burn_rate",
    "Fleet-level error-budget burn rate over the recent window (bad "
    "ratio / budget; 1.0 = burning exactly at the sustainable rate).",
    labels=("slo",),
)
FLEET_SLO_REMAINING = REGISTRY.gauge(
    "fleet_slo_error_budget_remaining_ratio",
    "Fleet-level lifetime error budget remaining (1 = untouched, 0 = "
    "spent, negative = blown).",
    labels=("slo",),
)
FLEET_SLO_TARGET = REGISTRY.gauge(
    "fleet_slo_target_ratio",
    "The declared fleet-level SLO target (constant).",
    labels=("slo",),
)

#: Merge-rejection reasons (the ``fleet_scrape_merge_rejected_total``
#: label space).
REJECT_REASONS = (
    "bucket_mismatch", "kind_mismatch", "label_mismatch", "unsupported",
    "router_owned",
)


def fleet_slo_tracker(
    slos: list[SLO] | None = None, window: int = 2048,
) -> SLOTracker:
    """An ``SLOTracker`` publishing on the ``fleet_slo_*`` families —
    the same evaluation/burn machinery as the per-process tracker,
    pointed at the registered fleet-level names."""
    return SLOTracker(
        slos if slos is not None else default_slos(),
        window=window,
        families={
            "requests": FLEET_SLO_REQUESTS,
            "bad": FLEET_SLO_BAD,
            "good_ratio": FLEET_SLO_GOOD,
            "burn": FLEET_SLO_BURN,
            "remaining": FLEET_SLO_REMAINING,
            "target": FLEET_SLO_TARGET,
        },
    )


# ---------------------------------------------------------------------------
# exposition parsing (text format 0.0.4, the subset our stack renders)
# ---------------------------------------------------------------------------


def _parse_value(tok: str) -> float:
    if tok in ("+Inf", "Inf"):
        return float("inf")
    if tok == "-Inf":
        return float("-inf")
    if tok == "NaN":
        return float("nan")
    return float(tok)


def _parse_labels(raw: str) -> dict[str, str]:
    """The ``{...}`` body → dict, honoring the three legal escapes."""
    out: dict[str, str] = {}
    i, n = 0, len(raw)
    while i < n:
        while i < n and raw[i] in ", ":
            i += 1
        if i >= n:
            break
        eq = raw.index("=", i)
        key = raw[i:eq].strip()
        i = eq + 1
        if i >= n or raw[i] != '"':
            raise ValueError(f"unquoted label value for {key!r}")
        i += 1
        buf: list[str] = []
        while i < n:
            c = raw[i]
            if c == "\\" and i + 1 < n:
                buf.append({"n": "\n"}.get(raw[i + 1], raw[i + 1]))
                i += 2
            elif c == '"':
                i += 1
                break
            else:
                buf.append(c)
                i += 1
        out[key] = "".join(buf)
    return out


def parse_exposition(text: str) -> dict[str, dict]:
    """One page → ``{family: {"kind", "help", "series"}}``.

    ``series`` maps a sorted ``((label, value), ...)`` key to the sample
    value for counters/gauges, and to ``{"buckets": {le: count}, "sum",
    "count"}`` for histograms (the ``le`` label lifted out of the key).
    Unparseable lines raise ``ValueError`` — a replica page that fails
    here fails its scrape, which the caller marks stale rather than
    merging garbage.
    """
    families: dict[str, dict] = {}
    types: dict[str, str] = {}

    def fam(name: str) -> dict:
        f = families.get(name)
        if f is None:
            f = families[name] = {
                "kind": types.get(name, "untyped"), "help": "",
                "series": {},
            }
        return f

    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                types[parts[2]] = parts[3].strip() if len(parts) > 3 \
                    else "untyped"
                fam(parts[2])["kind"] = types[parts[2]]
            elif len(parts) >= 3 and parts[1] == "HELP":
                fam(parts[2])["help"] = parts[3] if len(parts) > 3 else ""
            continue
        brace = line.find("{")
        space = line.find(" ")
        if brace != -1 and (space == -1 or brace < space):
            name = line[:brace]
            end = line.rindex("}")
            labels = _parse_labels(line[brace + 1:end])
            tail = line[end + 1:].split()
        else:
            toks = line.split()
            name, labels, tail = toks[0], {}, toks[1:]
        if not tail:
            raise ValueError(f"sample without a value: {line!r}")
        value = _parse_value(tail[0])

        base, suffix = name, ""
        for sfx in ("_bucket", "_sum", "_count"):
            if name.endswith(sfx) and \
                    types.get(name[: -len(sfx)]) == "histogram":
                base, suffix = name[: -len(sfx)], sfx
                break
        f = fam(base)
        if f["kind"] == "histogram":
            key = tuple(sorted(
                (k, v) for k, v in labels.items() if k != "le"
            ))
            series = f["series"].setdefault(
                key, {"buckets": {}, "sum": 0.0, "count": 0.0}
            )
            if suffix == "_bucket":
                series["buckets"][labels.get("le", "")] = value
            elif suffix == "_sum":
                series["sum"] = value
            elif suffix == "_count":
                series["count"] = value
            else:
                raise ValueError(
                    f"bare sample {name!r} in histogram family {base!r}"
                )
        else:
            f["series"][tuple(sorted(labels.items()))] = value
    return families


# ---------------------------------------------------------------------------
# merging
# ---------------------------------------------------------------------------


def _label_names(family: dict) -> set[tuple[str, ...]]:
    """The distinct label-name tuples across a family's series (one
    element = consistent labeling)."""
    return {
        tuple(k for k, _ in key) for key in family["series"]
    }


def merge_expositions(
    pages: dict[str, dict[str, dict]],
    drop: frozenset[str] | set[str] = frozenset(),
) -> tuple[dict[str, dict], list[dict]]:
    """Merge parsed per-replica pages (``{replica: parse_exposition(…)}``)
    into one family map, applying the per-kind semantics from the module
    docstring. ``drop`` lists router-owned family names to exclude
    (``reason="router_owned"``). Returns ``(merged, rejected)`` where
    ``rejected`` is ``[{"name", "reason"}, ...]`` — also counted on
    ``fleet_scrape_merge_rejected_total``."""
    by_family: dict[str, list[tuple[str, dict]]] = {}
    for replica in sorted(pages):
        for name, family in pages[replica].items():
            if not family["series"]:
                continue  # TYPE/HELP with no samples: nothing to merge
            by_family.setdefault(name, []).append((replica, family))

    merged: dict[str, dict] = {}
    rejected: list[dict] = []

    def reject(name: str, reason: str) -> None:
        rejected.append({"name": name, "reason": reason})
        FLEET_MERGE_REJECTED.inc(reason=reason)

    for name, copies in sorted(by_family.items()):
        if name in drop:
            reject(name, "router_owned")
            continue
        kinds = {family["kind"] for _, family in copies}
        if len(kinds) > 1:
            reject(name, "kind_mismatch")
            continue
        kind = kinds.pop()
        if kind not in ("counter", "gauge", "histogram"):
            reject(name, "unsupported")
            continue
        label_names = set()
        for _, family in copies:
            label_names |= _label_names(family)
        if len(label_names) > 1 or (
            kind == "gauge" and label_names and
            "replica" in next(iter(label_names))
        ):
            # Inconsistent label keys cannot merge into one family; a
            # replica-side gauge already labeled `replica` would collide
            # with the label this merge appends.
            reject(name, "label_mismatch")
            continue
        help_ = next(
            (f["help"] for _, f in copies if f["help"]), ""
        )
        out = {"kind": kind, "help": help_, "series": {}}
        if kind == "counter":
            for _, family in copies:
                for key, value in family["series"].items():
                    out["series"][key] = out["series"].get(key, 0.0) + value
        elif kind == "gauge":
            for replica, family in copies:
                for key, value in family["series"].items():
                    out["series"][
                        tuple(sorted(key + (("replica", replica),)))
                    ] = value
        else:  # histogram: identical-boundary bucket merge
            bounds = None
            ok = True
            for _, family in copies:
                for series in family["series"].values():
                    les = tuple(sorted(series["buckets"]))
                    if bounds is None:
                        bounds = les
                    elif les != bounds:
                        ok = False
                        break
                if not ok:
                    break
            if not ok:
                reject(name, "bucket_mismatch")
                continue
            for _, family in copies:
                for key, series in family["series"].items():
                    acc = out["series"].setdefault(
                        key, {"buckets": dict.fromkeys(bounds, 0.0),
                              "sum": 0.0, "count": 0.0},
                    )
                    for le, v in series["buckets"].items():
                        acc["buckets"][le] += v
                    acc["sum"] += series["sum"]
                    acc["count"] += series["count"]
        merged[name] = out
    return merged, rejected


def _fmt(v: float) -> str:
    if v != v:
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _series_name(name: str, key: tuple, extra: dict | None = None) -> str:
    pairs = list(key) + list((extra or {}).items())
    if not pairs:
        return name
    inner = ",".join(
        f'{k}="{_escape_label_value(str(v))}"' for k, v in pairs
    )
    return f"{name}{{{inner}}}"


def _le_sort(le: str) -> float:
    try:
        return _parse_value(le)
    except ValueError:
        return float("inf")


def render_merged(merged: dict[str, dict]) -> str:
    """The merged family map → strict text exposition (one contiguous
    group per family, TYPE before samples, trailing newline)."""
    lines: list[str] = []
    for name, family in sorted(merged.items()):
        help_ = family["help"].replace("\n", " ")
        lines.append(f"# HELP {name} {help_}".rstrip())
        lines.append(f"# TYPE {name} {family['kind']}")
        if family["kind"] == "histogram":
            for key, series in sorted(family["series"].items()):
                for le in sorted(series["buckets"], key=_le_sort):
                    lines.append(
                        f"{_series_name(name + '_bucket', key, {'le': le})}"
                        f" {_fmt(series['buckets'][le])}"
                    )
                lines.append(
                    f"{_series_name(name + '_sum', key)} "
                    f"{_fmt(series['sum'])}"
                )
                lines.append(
                    f"{_series_name(name + '_count', key)} "
                    f"{_fmt(series['count'])}"
                )
        else:
            for key, value in sorted(family["series"].items()):
                lines.append(f"{_series_name(name, key)} {_fmt(value)}")
    return "\n".join(lines) + "\n" if lines else ""


# ---------------------------------------------------------------------------
# the scraper behind GET /fleet/metrics
# ---------------------------------------------------------------------------


class FleetScraper:
    """Scrape in-rotation replicas and render the aggregated page
    (module docstring). ``render_fleet_page`` blocks for up to
    ``timeout_s`` per replica — callers run it on a short-lived thread
    off the router's event loop (the ``/debug/profile`` pattern)."""

    def __init__(
        self,
        registry,
        metrics_registry: MetricsRegistry | None = None,
        timeout_s: float = 1.0,
    ) -> None:
        self.registry = registry  # fleet.registry.ReplicaRegistry
        self.metrics_registry = metrics_registry or REGISTRY
        self.timeout_s = float(timeout_s)
        self._lock = threading.Lock()
        self._stale: dict[str, bool] = {}

    def _mark(self, replica_id: str, stale: bool) -> None:
        FLEET_SCRAPES.inc(result="error" if stale else "ok")
        FLEET_SCRAPE_STALE.set(1.0 if stale else 0.0, replica=replica_id)
        with self._lock:
            prev = self._stale.get(replica_id)
            self._stale[replica_id] = stale
        if prev != stale and (prev is not None or stale):
            # Journal transitions (and a first-ever-stale observation);
            # a steady state repeated every scrape would drown the log.
            journal.event(
                "fleet_scrape_transition", replica=replica_id, stale=stale,
            )

    def forget(self, replica_id: str) -> None:
        """Retire a departed replica's scrape state AND its
        ``fleet_scrape_stale`` series. Wired to the registry's retire
        listeners: a deregistered (or replaced) replica must vanish
        from the exposition, not linger at its last value — a frozen
        stale=1 would page forever, a frozen stale=0 would mask that
        the replica is gone."""
        with self._lock:
            self._stale.pop(replica_id, None)
        FLEET_SCRAPE_STALE.remove(replica=replica_id)

    def scrape(self) -> tuple[dict[str, dict], dict]:
        """One scrape pass over the in-rotation membership: returns
        ``(parsed_pages, summary)``; every replica lands in exactly one
        of ``summary["scraped"]`` / ``summary["stale"]``."""
        pages: dict[str, dict] = {}
        summary: dict = {"scraped": [], "stale": []}
        for rep in self.registry.snapshot():
            if not rep["in_rotation"]:
                continue
            rid = rep["id"]
            try:
                with urllib.request.urlopen(
                    rep["url"].rstrip("/") + "/metrics",
                    timeout=self.timeout_s,
                ) as resp:
                    pages[rid] = parse_exposition(
                        resp.read().decode("utf-8", "replace")
                    )
            except Exception:
                self._mark(rid, stale=True)
                summary["stale"].append(rid)
                continue
            self._mark(rid, stale=False)
            summary["scraped"].append(rid)
        return pages, summary

    def render_fleet_page(self) -> tuple[str, dict]:
        """Scrape + merge + append the router's own families: the full
        ``/fleet/metrics`` page and its summary. The router's own
        registry render carries the scrape/staleness/SLO families
        updated by this very pass, so the page describes its own
        production."""
        pages, summary = self.scrape()
        own = frozenset(
            fam.name for fam in self.metrics_registry.families()
        )
        merged, rejected = merge_expositions(pages, drop=own)
        text = render_merged(merged) + \
            self.metrics_registry.render_prometheus()
        summary.update(
            replicas_merged=len(pages),
            families_merged=len(merged),
            rejected=rejected,
        )
        return text, summary
