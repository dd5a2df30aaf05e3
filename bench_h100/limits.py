"""The readings a cell's limits are set from (checks/<cell>.json).

From the checkout's root, on a card:

    python3 bench_h100/limits.py --workload <cell> --seconds <s> \
        --program-seeds <n> ... --control-seeds <n> ...

For each program seed, one whole run of the cell (set-up, a window of
`seconds`, the reference) and its compared numbers; for each control
seed, the control's numbers: the reference with the scene math's matrix
products on TF32 operands, in the program's place.  One JSON line each,
then the largest program reading and the smallest control reading of
each number.  The benchmark's own runs never run the control.
"""

import argparse
import json
import os
import sys
import time


def control_numbers(cell, seed, device):
    """The control's numbers on `seed`: the TF32 reference's kept
    outputs against the float32 reference's."""
    from bench_h100.harness import check, inputs
    data = inputs.make_inputs(cell, seed, device)
    kept = inputs.kept_samples(seed, cell.traffic, cell.config["batch"])
    want = check.reference_outputs(cell, data, kept)
    got = check.reference_outputs(cell, data, kept, round_operands=True)
    return check.numbers(got, want)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--program-seeds", type=int, nargs="*", default=())
    parser.add_argument("--control-seeds", type=int, nargs="*", default=())
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    from bench_h100.harness import check, runner, spec
    cell = spec.load_cell(args.workload)
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    worst = dict.fromkeys(check.NUMBERS, 0.0)
    least = dict.fromkeys(check.NUMBERS, float("inf"))
    for seed in args.program_seeds:
        result = runner.measure(cell, seed, args.seconds, 0, device,
                                time.perf_counter())
        print(json.dumps({"side": "program", "seed": seed,
                          "steps": result.steps, **result.numbers}),
              flush=True)
        worst = {k: max(worst[k], result.numbers[k]) for k in worst}
    for seed in args.control_seeds:
        values = control_numbers(cell, seed, device)
        print(json.dumps({"side": "control", "seed": seed, **values}),
              flush=True)
        least = {k: min(least[k], values[k]) for k in least}
    print(json.dumps({"workload": args.workload, "program_max": worst,
                      "control_min": least}), flush=True)


if __name__ == "__main__":
    main()
