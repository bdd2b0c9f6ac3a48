"""The readings that the limits of `correct` are set from: for each seed,
one run of a cell (its set-up and a window of the given seconds) whose
captured outputs are judged twice, once as the program's and once with the
control (the reference in bfloat16) in the program's place. All seeds run
in one process, so set-up's imports are paid once.

    python3 slambench/readings.py --workload <cell> --seeds 1,2,3
        --seconds <s> [--out <file.jsonl>]

Prints one JSON line per seed: the seed, the program's numbers and
verdict, the control's numbers and verdict, and the run's end-to-end
numbers. The benchmark's own runs never run the control.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seeds, seconds: float, device):
    """Yield one record per seed (see the module's docstring)."""
    import gc

    import torch
    from slambench.reference.check import verdict
    from slambench.run import Context
    for seed in seeds:
        t = time.perf_counter()
        out = cell.driver().run(Context(cell, seed, seconds, False, device,
                                        t, control=True))
        limits = cell.file["limits"]
        yield {"seed": seed,
               "program": out["numbers"],
               "program_correct": verdict(out["numbers"], limits)[0],
               "control": out["control_numbers"],
               "control_correct": verdict(out["control_numbers"], limits)[0],
               "attempted": out["attempted"], "failed": out["failed"],
               "end_to_end": out["end_to_end"]}
        del out
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from slambench import harness
    harness.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("slambench: no CUDA card; no readings", file=sys.stderr)
        return 3
    cell = harness.Cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    sink = open(args.out, "a") if args.out else None
    try:
        for rec in readings(cell, seeds, args.seconds, "cuda"):
            line = json.dumps(rec)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
