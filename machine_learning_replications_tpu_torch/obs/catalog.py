"""The closed catalogs of the port's metric families and journal events.

The port's own catalog, not the JAX package's ``obs/catalog.py``: every
family ``obs.torchmon`` registers in the port's registry, and every journal
event the port emits, with the keys each emit site must carry (the event
entries keep the JAX catalog's names and required keys). Both dicts stay
literal (no comprehensions, no calls) so a test can read this file with
``ast.literal_eval`` and hold the code to it in both directions: a family
registered or an event emitted outside the catalog fails, and so does a
catalog entry nothing registers or emits
(``tests/test_torch_obs.py::test_code_and_catalog_agree``).
"""

from __future__ import annotations

#: Every process-global metric family: name -> (kind, label names).
#: Kind is "counter" | "gauge" | "histogram".
METRICS: dict[str, tuple[str, tuple[str, ...]]] = {
    # -- obs/torchmon --------------------------------------------------------
    "torch_graph_captures_total": ("counter", ()),
    "torch_kernel_builds_total": ("counter", ()),
    "torch_kernel_build_seconds_total": ("counter", ()),
    "torch_kernel_launches_total": ("counter", ("kernel",)),
    "torch_transfer_bytes_total": ("counter", ("direction",)),
}

#: Every journal event kind -> the keys EVERY emit site must carry.
#: The run manifest record (kind="manifest") is written directly by
#: ``RunJournal.__init__``, not through ``event``, and is not an entry.
EVENTS: dict[str, tuple[str, ...]] = {
    # -- run lifecycle (cli, journal) ---------------------------------------
    "run_done": (),
    "run_error": ("error",),
    "stage_start": ("stage",),
    "stage_done": ("stage", "seconds", "checkpointed"),
    "stage_error": ("stage", "seconds", "error"),
    # -- checkpoints (persist/) ---------------------------------------------
    "checkpoint_publish": ("path", "version"),
    "checkpoint_restore": ("stage",),
    "checkpoint_corrupt": ("stage", "error"),
}
