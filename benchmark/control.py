"""The readings that the limits of ``correct`` are set from, on the card:

    python3 benchmark/control.py --workload <name> --seeds 1,2,... \
        --control-seeds 101,102,103 --seconds 6

runs the cell once per seed in one process (the kernels are built and
loaded once), each with a short window at the cell's own size: the
program as it is for ``--seeds``, and the control for ``--control-seeds``.
It prints each run's result line, then one JSON line with the numbers
compared per seed. The benchmark's own runs never run the control.

The configuration states float32 streams and a lossless guarantee. The
control is the program fed its float streams rounded to bfloat16, the
nearest precision below float32: the lossy store that would tempt a later
change, which the check has to refuse.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def bfloat16_rounded(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16, as float32."""
    import torch
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16).float().numpy()


def control_program(base):
    """The control: ``base`` (a harness Program class) fed bfloat16-rounded
    float streams."""

    class LowPrecision(base):
        def write(self, streams):
            return super().write({k: bfloat16_rounded(v) if v.dtype == np.float32 else v
                                  for k, v in streams.items()})
    return LowPrecision


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="sound and control readings of a cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)
    os.environ["TRICO_TPU_BUILD_DIR"] = str(ROOT / "build")
    if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness
    if not torch.cuda.is_available():
        print("the readings are taken on the card", file=sys.stderr)
        return 2
    readings = {"workload": args.workload, "sound": {}, "control": {}}
    runs = [("sound", int(s), harness.Program) for s in args.seeds.split(",")]
    runs += [("control", int(s), control_program(harness.Program))
             for s in args.control_seeds.split(",")]
    for kind, seed, cls in runs:
        t = time.perf_counter()
        res = harness.run_cell(ROOT, args.workload, seed, args.seconds, False,
                               program_cls=cls)
        readings[kind][seed] = {k: v["value"] for k, v in res["checks"].items()
                                if "limit" in v}
        readings[kind][seed]["correct"] = res["correct"]
        readings[kind][seed]["attempted"] = res["attempted"]
        print(f"{kind} seed {seed}: {time.perf_counter() - t:.1f} s", file=sys.stderr)
    print(json.dumps(readings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
