"""Run one cell of the benchmark of `orb_slam2_e_tpu_torch` once.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1` a
`breakdown`, and last `checks`, each number the reference compared with
its limit; the last lines of standard error give the same numbers. A run
that finds no card, or fewer than the cell asks for, or a JAX module
loaded once the window has closed, exits with a code other than 0 and
prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


class Context:
    """One run's arguments, handed to the cell's traffic driver."""

    def __init__(self, cell, seed, seconds, trace, device, t_start,
                 control=False):
        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.t_start = t_start
        self.control = control


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float):
    """Drive the cell; return the driver's output and the result line (no
    check for a card: the CPU tests call this directly)."""
    import torch
    from slambench import harness
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = cell.driver().run(Context(cell, seed, seconds, trace, device,
                                    t_start))
    dev = torch.device(device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return out, harness.result_line(cell, out, trace, name, cell.chips)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from slambench import harness
    harness.set_cache_dirs()
    import torch
    cell = harness.Cell(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"slambench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); found {found}; no result", file=sys.stderr)
        return 3
    out, line = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T_START)
    bad = harness.forbidden_modules(list(sys.modules))
    if bad:
        print("slambench: JAX modules loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 4
    harness.stderr_lines(out, line)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
