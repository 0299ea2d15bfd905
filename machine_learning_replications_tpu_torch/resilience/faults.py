"""Deterministic process-global fault injection (chaos-engineering primitive).

A robustness claim that was never exercised is a guess: "the server sheds
instead of hanging when the device wedges" is only true once a wedged
device has actually been simulated against a live server and the 503s
counted. This module is the injection half of that loop.

**Sites.** A faultpoint is a named call to ``fire(site)`` woven into a hot
path. The catalog (``SITES``) is closed — arming an unknown site is an
error, so a typo'd chaos spec fails at arm time, not by silently injecting
nothing. graftcheck's ``faultpoint-coherence`` rule (docs/ANALYSIS.md)
keeps the three views — ``fire()`` sites in code, this catalog, and the
docs/RESILIENCE.md table — in exact agreement:

  ==================  =============================================  ==========
  site                where it fires                                 modes
  ==================  =============================================  ==========
  server.parse        ``serve/server.py`` request admission, before  raise delay
                      the body is parsed
  server.respond      before the 200 reply body is written           raise delay
  batcher.flush       ``serve/batcher.py`` flush, before the batch   raise delay
                      is stacked and handed to the engine
  engine.compute      ``serve/engine.py`` ``predict``, before the    raise delay
                      device computation (inside the supervisor's
                      watchdog window — a long delay here IS a
                      wedged device)
  engine.warmup       ``serve/engine.py`` ``warmup`` entry (makes    raise delay
                      supervised restarts fail and retry)
  persist.save        ``persist/orbax_io.py`` after the checkpoint   raise delay
                      tree is written but before it is checksummed   corrupt
                      and published (raise = save interrupted
                      mid-write; corrupt = bytes torn after
                      checksumming)
  persist.restore     ``persist/orbax_io.py`` restore entry           raise delay
                      (corrupt = flip bytes on disk so integrity     corrupt
                      verification must catch it)
  persist.aot_restore ``persist/aot.py`` per-bucket AOT executable   raise delay
                      load (raise = a failing restore; corrupt =     corrupt
                      the blob's bytes torn before deserialization
                      — both must resolve to the engine's journaled
                      fails-open fallback to tracing, docs/AOT.md)
  lifecycle.spawn     ``fleet/lifecycle.py`` replica spawn entry     raise delay
                      (raise = the spawn attempt itself fails;       corrupt
                      corrupt = the manager launches a replica that
                      can never become ready — the ready-deadline
                      branch must catch it and fail closed)
  lifecycle.drain     ``fleet/lifecycle.py`` drain-first retirement  raise delay
                      entry (raise = the retirement is aborted and   corrupt
                      retried; corrupt = the graceful SIGTERM is
                      suppressed, simulating a replica that refuses
                      to drain — the kill-deadline escalation must
                      fire)
  ==================  =============================================  ==========

**Modes.** ``raise`` throws ``InjectedFault`` from the faultpoint;
``delay=SECONDS`` sleeps there; ``corrupt`` returns True from ``fire`` and
the call site applies its own, site-defined corruption (only sites with a
defined corruption accept it — arming ``corrupt`` elsewhere fails).

**Schedules.** Deterministic by construction so a chaos run is replayable:
every call (default), ``@n=K`` (only the K-th call), ``@p=F,seed=S``
(seeded per-arm Bernoulli), ``@once`` (disarm after the first firing),
``@count=K`` (disarm after K firings).

**Spec grammar** (the ``cli serve --inject`` flag and the guarded
``POST /debug/faults`` endpoint both take it)::

    SITE:MODE[=ARG][@OPT[,OPT...]]

    engine.compute:raise                 fail every device compute
    engine.compute:delay=2.5@n=3         wedge only the 3rd compute 2.5 s
    batcher.flush:delay=0.05@p=0.1,seed=7   seeded 10% slow flushes
    persist.restore:corrupt@once         tear the next checkpoint read

Every firing is journaled (``fault_injected``) and counted in the
process-global ``fault_injected_total{site}`` family, so a chaos run's
injections are joinable against the breaker/rollback events they caused.

**Hot-path cost.** ``fire`` with nothing armed is one module-dict truthiness
check — no lock, no allocation — so leaving the faultpoints compiled into
production paths costs nothing measurable (asserted by the serve bench).
"""

from __future__ import annotations

import random
import threading
import time

from machine_learning_replications_tpu_torch.obs import journal
from machine_learning_replications_tpu_torch.obs.registry import REGISTRY


class InjectedFault(RuntimeError):
    """Raised by an armed raise-mode faultpoint."""


#: site -> modes it supports ("corrupt" only where the call site defines
#: a corruption to apply).
SITES: dict[str, tuple[str, ...]] = {
    "server.parse": ("raise", "delay"),
    "server.respond": ("raise", "delay"),
    "batcher.flush": ("raise", "delay"),
    "engine.compute": ("raise", "delay"),
    "engine.warmup": ("raise", "delay"),
    "persist.save": ("raise", "delay", "corrupt"),
    "persist.restore": ("raise", "delay", "corrupt"),
    "persist.aot_restore": ("raise", "delay", "corrupt"),
    "lifecycle.spawn": ("raise", "delay", "corrupt"),
    "lifecycle.drain": ("raise", "delay", "corrupt"),
}

# Registered at import so the family (and its exposition metadata) exists
# on the first /metrics scrape of a chaos run, before anything fires
# (rule metrics-catalog).
FAULTS_INJECTED = REGISTRY.counter(
    "fault_injected_total",
    "Armed faultpoint firings by injection site (resilience.faults).",
    labels=("site",),
)


class FaultSpec:
    """One parsed injection directive: site, mode, and firing schedule."""

    __slots__ = ("site", "mode", "delay_s", "nth", "prob", "seed", "once",
                 "count")

    def __init__(
        self,
        site: str,
        mode: str,
        delay_s: float = 0.0,
        nth: int | None = None,
        prob: float | None = None,
        seed: int | None = None,
        once: bool = False,
        count: int | None = None,
    ) -> None:
        if site not in SITES:
            raise ValueError(
                f"unknown faultpoint site {site!r}; sites: "
                f"{', '.join(sorted(SITES))}"
            )
        if mode not in SITES[site]:
            raise ValueError(
                f"site {site!r} does not support mode {mode!r} "
                f"(supported: {', '.join(SITES[site])})"
            )
        if mode == "delay" and not delay_s > 0:
            raise ValueError("delay mode needs a positive seconds arg "
                             "(e.g. batcher.flush:delay=0.5)")
        if nth is not None and nth < 1:
            raise ValueError(f"@n must be >= 1, got {nth}")
        if prob is not None and not 0.0 < prob <= 1.0:
            raise ValueError(f"@p must be in (0, 1], got {prob}")
        if count is not None and count < 1:
            raise ValueError(f"@count must be >= 1, got {count}")
        if nth is not None and prob is not None:
            raise ValueError("@n and @p are mutually exclusive")
        self.site = site
        self.mode = mode
        self.delay_s = float(delay_s)
        self.nth = nth
        self.prob = prob
        self.seed = seed
        self.once = once
        self.count = count

    def describe(self) -> str:
        """Round-trippable spec string (the journal/snapshot rendering)."""
        s = f"{self.site}:{self.mode}"
        if self.mode == "delay":
            s += f"={self.delay_s:g}"
        opts = []
        if self.nth is not None:
            opts.append(f"n={self.nth}")
        if self.prob is not None:
            opts.append(f"p={self.prob:g}")
        if self.seed is not None:
            opts.append(f"seed={self.seed}")
        if self.once:
            opts.append("once")
        if self.count is not None:
            opts.append(f"count={self.count}")
        return s + ("@" + ",".join(opts) if opts else "")


def parse_spec(text: str) -> FaultSpec:
    """``SITE:MODE[=ARG][@OPT,...]`` -> FaultSpec (see module docstring)."""
    head, _, opts = text.strip().partition("@")
    site, sep, mode = head.partition(":")
    if not sep or not mode:
        raise ValueError(
            f"bad fault spec {text!r}: expected SITE:MODE[=ARG][@OPTS]"
        )
    mode, _, arg = mode.partition("=")
    delay_s = 0.0
    if mode == "delay":
        if not arg:
            raise ValueError(
                f"bad fault spec {text!r}: delay needs seconds "
                "(delay=SECONDS)"
            )
        delay_s = float(arg)
    elif arg:
        raise ValueError(
            f"bad fault spec {text!r}: mode {mode!r} takes no argument"
        )
    kw: dict = {}
    if opts:
        for opt in opts.split(","):
            key, has_val, val = opt.strip().partition("=")
            if key == "once" and not has_val:
                kw["once"] = True
            elif key == "n" and has_val:
                kw["nth"] = int(val)
            elif key == "p" and has_val:
                kw["prob"] = float(val)
            elif key == "seed" and has_val:
                kw["seed"] = int(val)
            elif key == "count" and has_val:
                kw["count"] = int(val)
            else:
                raise ValueError(
                    f"bad fault spec option {opt.strip()!r} "
                    "(known: n=K, p=F, seed=S, once, count=K)"
                )
    return FaultSpec(site.strip(), mode, delay_s=delay_s, **kw)


class _Armed:
    __slots__ = ("spec", "calls", "fires", "rng")

    def __init__(self, spec: FaultSpec) -> None:
        self.spec = spec
        self.calls = 0
        self.fires = 0
        # Seeded per-arm: a probabilistic schedule replays exactly.
        self.rng = random.Random(spec.seed if spec.seed is not None else 0)


_lock = threading.Lock()
_armed: dict[str, _Armed] = {}
_endpoint_enabled = False


def arm(spec: FaultSpec | str) -> FaultSpec:
    """Arm (or re-arm, replacing) a site's injection. Accepts a parsed
    ``FaultSpec`` or the spec-grammar string."""
    if isinstance(spec, str):
        spec = parse_spec(spec)
    with _lock:
        _armed[spec.site] = _Armed(spec)
    journal.event("fault_armed", site=spec.site, spec=spec.describe())
    return spec


def disarm(site: str) -> bool:
    """Disarm a site; True when something was armed there."""
    with _lock:
        was = _armed.pop(site, None)
    if was is not None:
        journal.event("fault_disarmed", site=site)
    return was is not None


def reset() -> None:
    """Disarm every site (firing counters in the registry are kept —
    counters are monotonic). Journaled like arm/disarm: the injection
    timeline must show WHERE injections stopped, or the chaos replay
    cannot tie recovery to the disarm."""
    with _lock:
        sites = sorted(_armed)
        _armed.clear()
    if sites:
        journal.event("faults_reset", sites=sites)


def snapshot() -> dict:
    """Armed sites with their specs and call/fire counts (the
    ``/debug/faults`` payload)."""
    with _lock:
        return {
            "endpoint_enabled": _endpoint_enabled,
            "armed": {
                site: {
                    "spec": a.spec.describe(),
                    "mode": a.spec.mode,
                    "calls": a.calls,
                    "fires": a.fires,
                }
                for site, a in sorted(_armed.items())
            },
        }


def enable_endpoint() -> None:
    """Allow ``/debug/faults`` to arm/disarm over HTTP. Off by default and
    one-way for the process lifetime: a production server must opt into
    being chaos-driven (``cli serve --inject``/``--fault-endpoint``)."""
    global _endpoint_enabled
    with _lock:
        _endpoint_enabled = True


def endpoint_enabled() -> bool:
    return _endpoint_enabled


def fire(site: str) -> bool:
    """The faultpoint. No-op (and near-free: one dict truthiness check)
    while nothing is armed anywhere. When this site is armed and its
    schedule hits: journal + count the firing, then raise
    (``InjectedFault``), sleep (delay mode), or return True (corrupt mode
    — the call site applies its corruption). Returns False otherwise."""
    if not _armed:  # hot path: unlocked read is exact enough (GIL dict op)
        return False
    with _lock:
        a = _armed.get(site)
        if a is None:
            return False
        a.calls += 1
        spec = a.spec
        if spec.nth is not None:
            hit = a.calls == spec.nth
        elif spec.prob is not None:
            hit = a.rng.random() < spec.prob
        else:
            hit = True
        if not hit:
            return False
        a.fires += 1
        fires = a.fires
        # Exhausted schedules self-disarm: @once and @n fire exactly once
        # by definition, @count after its quota.
        if spec.once or spec.nth is not None or (
            spec.count is not None and fires >= spec.count
        ):
            del _armed[site]
    FAULTS_INJECTED.inc(site=site)
    journal.event(
        "fault_injected", site=site, mode=spec.mode, fire=fires,
        spec=spec.describe(),
    )
    if spec.mode == "delay":
        time.sleep(spec.delay_s)
        return False
    if spec.mode == "raise":
        raise InjectedFault(f"injected fault at {site}")
    return True  # corrupt
