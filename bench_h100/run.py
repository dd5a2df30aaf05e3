"""Runs one cell of the benchmark of the PyTorch and CUDA port once.

From the checkout's root, on a machine with the cards the cell asks for:

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: `correct`,
`attempted` (steps in the window), `failed` (steps whose loss is not
finite), `metrics` (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), `device`, with --trace 1 `breakdown`, and last `checks`,
each compared number beside its limit; the same numbers end standard
error.  Exits non-zero, printing no result, where CUDA is missing or has
fewer cards than the cell asks for, or where jax, jaxlib, flax or the JAX
package was loaded once the window closed.
"""

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "dirt_tpu")


def forbidden_modules(modules):
    """The loaded top-level modules of FORBIDDEN, compared whole (the
    part of each name before its first dot)."""
    return sorted({name.split(".", 1)[0] for name in modules}
                  & set(FORBIDDEN))


def _process_start():
    from bench_h100.harness.window import process_age
    return _START - process_age()


def _card_line():
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"
    return out.stdout.strip()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    setup_start = _process_start()
    from bench_h100.harness import runner, spec, trace
    cell = spec.load_cell(args.workload)

    import dirt_tpu_torch  # noqa: F401  (the system under test)
    import torch
    if not torch.cuda.is_available():
        print("bench_h100: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"bench_h100: {torch.cuda.device_count()} CUDA devices, the "
              f"cell asks for {cell.chips}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    result = runner.measure(cell, args.seed, args.seconds, args.trace,
                            device, setup_start)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"bench_h100: loaded {found}", file=sys.stderr)
        return 3

    readings = result.readings
    device_line = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                       count=cell.chips, **result.device)
    line = {"correct": result.correct, "attempted": result.steps,
            "failed": result.failed}
    if args.trace:
        line["metrics"] = runner.metrics(readings, cell.per_layer)
        device_line.update(busy_s=readings.trace.busy_s,
                           window_s=readings.trace.window_s)
        line["device"] = device_line
        line["breakdown"] = trace.breakdown(readings.trace,
                                            readings.span_trace)
    else:
        line["metrics"] = runner.metrics(readings, cell.end_to_end)
        line["device"] = device_line
    # Infinity is not JSON: a number that could not be read (an entry
    # never kept, or a value not finite) is the string "inf".
    line["checks"] = {
        name: {"value": value if math.isfinite(value) else "inf",
               "limit": cell.limits[name]}
        for name, value in result.numbers.items()}
    steps = sorted(readings.window.step_seconds)
    print(f"bench_h100: {args.workload} seed {args.seed} on "
          f"{_card_line()}; {len(steps)} steps, ms min "
          f"{1e3 * steps[0]:.3f} median {1e3 * steps[len(steps) // 2]:.3f} "
          f"max {1e3 * steps[-1]:.3f}; cpus {sorted(os.sched_getaffinity(0))}"
          f", load {os.getloadavg()}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    for name, check in line["checks"].items():
        print(f"check {name}: {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
