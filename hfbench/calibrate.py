"""Readings that the output checks' limits are set from, on the card.

    python3 -m hfbench.calibrate --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3]

For each seed, in one process: set the cell up, run its timed path
(``job.calibration_calls`` calls: one fit; two passes over the engine's pool
of batches) and print the numbers of the job's own check (``job.check()``).
With ``--control-seeds`` also ``job.control()``: the same numbers for the
plain reference in the precision below the configuration's, in the
program's place. With ``--fault-seeds`` the check's numbers with each fault
of the job module's ``FAULTS`` planted under the timed path. One JSON line
per reading. A new entry kind brings its check, control and faults in its
own ``jobs/<job>.py``; nothing here changes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def checked(job) -> dict:
    """The check's numbers after one pass of the timed path."""
    for i in range(job.calibration_calls):
        job.call(i)
    return {name: value for name, (value, _) in job.check()[0].items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    args = ap.parse_args(argv)

    from hfbench import harness

    harness.apply_cache_env()
    import torch

    torch.set_num_threads(1)

    r = harness.resolve(harness.manifest(), args.workload)
    job_mod = harness.load_module(r["job_path"], f"hfbench_job_{r['config']['job']}")
    dev = torch.device("cuda", torch.cuda.current_device())

    def emit(**fields):
        print(json.dumps(dict(workload=args.workload, **fields)), flush=True)

    for seed in sorted(set(args.seeds) | set(args.control_seeds) | set(args.fault_seeds)):
        t0 = time.perf_counter()
        job = job_mod.setup(r["config"], r["cell"], seed, dev)
        if seed in args.seeds:
            emit(seed=seed, kind="program", **checked(job))
        if seed in args.fault_seeds:
            for name, fault in job_mod.FAULTS.items():
                with fault():
                    emit(seed=seed, kind=f"fault:{name}", **checked(job))
        if seed in args.control_seeds:
            emit(seed=seed, kind="control", **job.control())
        emit(seed=seed, kind="seconds", seconds=time.perf_counter() - t0)
        del job
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
