"""Thread-ownership annotations for the event-loop transport stack.

The transport's one-loop-thread-owns-every-socket architecture
(``serve/transport.py``, ``fleet/router.py``) rests on two contracts that
used to live only in docstrings:

  * ``@loop_only`` — the function runs ON the event-loop thread, and only
    there. It may touch selector state and connection objects without
    locks, and it must never block: no ``time.sleep``, no blocking
    connects, no ``http.client``, no un-timed ``Lock.acquire`` (one slow
    call stalls every connection the loop owns).
  * ``@cross_thread`` — the function is safe to call from ANY thread
    (it marshals onto the loop via the wake pipe / ``_post``). It must
    not call ``@loop_only`` functions directly.

The decorators are runtime no-ops — they tag the function and return it
unchanged. graftcheck's ``loop-discipline`` rule (docs/ANALYSIS.md)
enforces both contracts statically over the AST, so a blocking call
introduced into a loop-side method fails CI instead of collapsing p99s
in production.
"""

from __future__ import annotations


def loop_only(fn):
    """Mark ``fn`` as event-loop-thread-only (see module docstring)."""
    fn.__loop_only__ = True
    return fn


def cross_thread(fn):
    """Mark ``fn`` as safe from any thread (see module docstring)."""
    fn.__cross_thread__ = True
    return fn
