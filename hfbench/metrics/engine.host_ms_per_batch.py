"""The host's own time per batch: ``engine.predict`` less ``engine.copy_out``
(whose host reads hold the wait for the replay) and less ``engine.replay``
(the ``graph.replay()`` call, whose host time under the profiler is the
profiler's own cost of a graph launch), on the host's clock, from the
program's spans (``hfbench.spanread``)."""


def read(s: dict):
    spans = s.get("spans", {})
    if s.get("unit") != "batch" or not s["calls"] or "engine.predict" not in spans:
        return None
    waits = sum(spans.get(k, {"host_s": 0.0})["host_s"]
                for k in ("engine.copy_out", "engine.replay"))
    return 1e3 * (spans["engine.predict"]["host_s"] - waits) / s["calls"]
