"""Time, on one NVIDIA GPU, the encodes whose predictor takes the sort kernels
(``predict_sort_xors`` / ``predict64_sort_xors``) for some candidate, in this
tree and in another checkout.

    python3 -m trico_tpu_torch.tools.sort_compare --parent DIR

``DIR`` is a checkout of another commit whose package has the same entry
points. In a fresh process per turn (parent, this, this, parent) it times,
from CUDA events (``bench.time_ms``, REPS calls back to back), three encodes:
``encode_f32_chunks_v2_adaptive`` of the f32 bench stream (8M values in
chunks of 4096) with ``F32_TPU_CANDIDATES`` (the bench's leg 2, whose (14,18)
candidate no window kernel holds), ``encode_f64_chunks_v2`` of the f64 bench
stream (16M doubles) at (20,20), the f64 default, and
``encode_f64_chunks_v2_adaptive`` of it with ``F64_TPU_CANDIDATES``. Both
trees must give the same compressed sizes. Holding the kernels against
their plain version and timing them alone is ``chip_smoke.py``'s phase 3.

Every line names the card and its power limit; the last is one JSON object.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from ..bench import smi

REPS = 10  # back-to-back calls a time is taken over
# the encodes timed in each tree: (name, code run with x and x64 on the card)
ENCODES = {
    "f32 adaptive (F32_TPU_CANDIDATES)":
        "fp_torch.encode_f32_chunks_v2_adaptive(x, fp_torch.F32_TPU_CANDIDATES)",
    "f64 (20,20)": "fp64_torch.encode_f64_chunks_v2(x64, 20, 20)",
    "f64 adaptive (F64_TPU_CANDIDATES)":
        "fp64_torch.encode_f64_chunks_v2_adaptive(x64, fp64_torch.F64_TPU_CANDIDATES)",
}
# one turn, run with the tree on PYTHONPATH
TURN = f"""
import json, sys, torch
from trico_tpu_torch import _u32, _u64
from trico_tpu_torch.bench import bench_stream, bench_stream64, time_ms
from trico_tpu_torch.codec import fp64_torch, fp_torch
x = _u32.from_numpy(bench_stream(1 << 23).reshape(-1, 4096)).cuda()
x64 = _u64.from_numpy(bench_stream64(1 << 24).reshape(-1, 4096)).cuda()
out = {{}}
for name, code in json.loads(sys.argv[1]).items():
    fn = eval("lambda: " + code)
    size = int(fn()[1].sum().item())
    out[name] = {{"ms": time_ms(fn, {REPS}), "bytes": size}}
print(json.dumps(out))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="a checkout of another commit: its package's encodes "
                         "are timed beside this tree's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sort_compare: needs a CUDA card", file=sys.stderr)
        return 1
    card = ", ".join(smi("name,power.limit", torch.device("cuda", 0)))
    here = Path(__file__).resolve().parents[2]
    trees = {"parent": args.parent.resolve(), "this": here}
    turns = []
    for which in ("parent", "this", "this", "parent"):
        env = dict(os.environ, PYTHONPATH=str(trees[which]))
        res = subprocess.run([sys.executable, "-c", TURN, json.dumps(ENCODES)],
                             cwd=trees[which], env=env, capture_output=True,
                             text=True, timeout=600)
        if res.returncode != 0:
            raise SystemExit(f"{which} turn failed:\n{res.stderr[-3000:]}")
        turns.append((which, json.loads(res.stdout.strip().splitlines()[-1])))
    encodes = {}
    for name in ENCODES:
        by = {"parent": [], "this": []}
        for which, out in turns:
            by[which].append(out[name]["ms"])
        sizes = {out[name]["bytes"] for _, out in turns}
        if len(sizes) != 1:
            raise SystemExit(f"{name}: the trees' sizes differ: {sizes}")
        encodes[name] = {"parent_ms": by["parent"], "this_ms": by["this"],
                         "bytes": sizes.pop()}
        print(f"encode {name}: parent {by['parent']} ms, this {by['this']} "
              f"ms (turns parent, this, this, parent), "
              f"{encodes[name]['bytes']} B in both [{card}]", flush=True)
    print(json.dumps({"card": card, "encodes": encodes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
