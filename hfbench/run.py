"""Run one cell of the benchmark once and print its result line.

    python3 -m hfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program. With ``--trace 0`` the
result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (from a profiled window) and the trace's breakdown. The
last line of standard output is the result as one JSON object; the last
lines of standard error are each number of the output check beside its
limit. Exits non-zero, printing no result, without a CUDA device (or fewer
than the cell asks for), or if the JAX stack was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from hfbench import harness

    harness.apply_cache_env()
    import torch

    torch.set_num_threads(1)                  # one process, few threads: steadier load

    chips = harness.resolve(harness.manifest(), args.workload)["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"hfbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              t_process=T_PROCESS)
    found = harness.forbidden_modules()
    if found:
        print(f"hfbench: the process loaded {', '.join(found)}", file=sys.stderr)
        return 4
    print(f"# device: {harness.power_limit()}", flush=True)
    print(f"hfbench: {result['window']}", file=sys.stderr)
    for name, (value, limit) in result["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
