"""Run one cell of BENCHMARK.json once on the card:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It sets up, measures for ``--seconds``,
checks the outputs against the NumPy reference and prints one JSON line
last. It exits with 2 and prints no result where there is no card, or
fewer cards than the cell asks for; with 3 where the run loaded a module
it must not. The program's build caches stay in ``build/`` inside the
checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["TRICO_TPU_BUILD_DIR"] = str(ROOT / "build")
    if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
        sys.path.pop(0)  # this folder's modules are imported as benchmark.*
    sys.path.insert(0, str(ROOT))

    import torch
    from benchmark import harness

    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in manifest["workloads"]}.get(args.workload)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import trico_tpu_torch  # noqa: F401  (no program, no run)
    try:
        harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                         bool(args.trace), t_start=T_START)
    except harness.BenchError as e:
        print(e, file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
