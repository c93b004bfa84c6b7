"""One run of one cell of ``BENCHMARK.json``: set up, measure, check, report.

Everything a cell needs is found by name: its configuration in
``configs/<name>.json``, its traffic in ``traffic/<name>.json`` and each
metric's reader in ``metrics/<name>.py`` (a module with ``read(run)``
that returns the value, or None where it finds nothing to read).

The traffic is a closed loop with one caller over a pool of meshes made
from the seed (``meshgen``: the traffic's ``pool`` draws of each mesh of
the configuration, draw-major): each iteration writes the next entry of
the pool and reads that archive back. A write hands host arrays to
``compress_mesh`` and ends when the archive bytes are on the host; a read
hands bytes to ``decompress_mesh`` and ends when the arrays are on the
host. Set-up loads the program's libraries (building them on a checkout's
first run), makes the pool, and writes and reads the first draw of each
mesh once, so that every shape of the window has been used; a
configuration of one mesh warms ``pool[0]`` alone. The window then runs
until ``--seconds`` have passed; the request that is running then is
finished and counted.

``correct`` is decided after the window, against the NumPy reference of
``reference/``. The run's archives are held once each (an archive equal
byte for byte to one written before for the same mesh is that one); the
reference decodes every one of them, and each is compared with its input
word for word. Every read is compared with its input at every
``STRIDE``-th word, and ``READ_SAMPLE`` reads drawn from the seed whole.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import meshgen
from .devtrace import Trace
from .reference import compare, decode_archives
from .spans import Spans

FORBIDDEN = ("jax", "jaxlib", "flax", "trico_tpu")
READ_SAMPLE = 4
STRIDE = 1009


class BenchError(Exception):
    """A run that must end without a result."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_metrics(manifest: dict, cell: str, section: str) -> list[dict]:
    """The metrics of ``section`` that ``cell`` reports."""
    return [m for m in manifest[section]
            if "workloads" not in m or cell in m["workloads"]]


def load_reader(bench: Path, name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``'s ``read``."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Request:
    kind: str        # "write" or "read"
    pool: int        # the pool entry it carried
    t0: float
    t1: float
    nbytes: int      # raw bytes in (write) or out (read)
    archive: bytes | None  # the archive it wrote or read


@dataclass
class Run:
    """What a run measured, for the metric readers."""

    cell: dict
    config: dict
    traffic: dict
    device_kind: str
    setup_s: float = 0.0
    build_s: float = 0.0
    window_s: float = 0.0
    requests: list = field(default_factory=list)
    pool_raw_bytes: list = field(default_factory=list)
    archive_bytes: dict = field(default_factory=dict)
    spans: Spans | None = None
    trace: Trace | None = None

    def of(self, kind: str) -> list[Request]:
        return [r for r in self.requests if r.kind == kind and r.archive is not None]

    def seconds(self, kind: str) -> float:
        return sum(r.t1 - r.t0 for r in self.of(kind))

    def nbytes(self, kind: str) -> int:
        return sum(r.nbytes for r in self.of(kind))


class Program:
    """The system under test: ``trico_tpu_torch.parallel``'s mesh codec on
    ``mesh``, with the configuration's codec settings. ``profile`` is the
    span recorder of a traced run."""

    def __init__(self, mesh, codec: dict):
        self.mesh, self.codec, self.profile = mesh, codec, None

    def write(self, streams: dict) -> bytes:
        from trico_tpu_torch.parallel import mesh_codec
        return mesh_codec.compress_mesh(**streams, mesh=self.mesh,
                                        chunk_len=self.codec["chunk_len"],
                                        optimize=self.codec["optimize"],
                                        profile=self.profile)

    def read(self, blob: bytes) -> dict:
        from trico_tpu_torch.parallel import mesh_codec
        return mesh_codec.decompress_mesh(blob, self.mesh)


def _nbytes(arrays: dict) -> int:
    return sum(np.asarray(a).nbytes for a in arrays.values())


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _load_libraries(device: str) -> None:
    """Load the program's host library and, on the card, its CUDA kernels:
    each is built first where the checkout has no current build."""
    from trico_tpu_torch import native
    if native.get_lib() is None:
        raise BenchError("the program's host library did not build")
    if device == "cuda":
        from trico_tpu_torch.codec import _build
        _build.lib()


def _forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _check(run: Run, pool: list[dict], reads: list, kept: list,
           failed: int, err) -> dict:
    """The numbers compared, each with its limit (exact: 0)."""
    distinct: list[tuple[int, bytes]] = []
    for k, blob in [(r.pool, r.archive) for r in run.of("write")]:
        if not any(k == j and blob is b for j, b in distinct):
            distinct.append((k, blob))
    archive_wrong = 0
    t0 = time.perf_counter()
    decoded = decode_archives([b for _, b in distinct])
    print(f"reference: {len(distinct)} archives decoded in {time.perf_counter() - t0:.3f} s",
          file=err)
    for (k, blob), got in zip(distinct, decoded):
        if isinstance(got, ValueError):
            print(f"reference: archive of pool entry {k} is malformed: {got}", file=err)
            archive_wrong += sum(compare.words(a).size for a in pool[k].values())
        else:
            archive_wrong += compare.words_wrong(got, pool[k])
    want = [compare.strided(p, STRIDE) for p in pool]
    read_wrong = sum(compare.strided_wrong(sample, want[k]) for k, sample in reads)
    read_wrong += sum(compare.words_wrong(out, pool[k]) for k, out in kept)
    return {
        "archive_words_wrong": {"value": archive_wrong, "limit": 0},
        "read_words_wrong": {"value": read_wrong, "limit": 0},
        "requests_failed": {"value": failed, "limit": 0},
        "archives_checked": {"value": len(distinct)},
        "reads_checked_whole": {"value": len(kept), "strided": len(reads)},
    }


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             *, device: str = "cuda", t_start: float | None = None,
             program_cls=Program, out=None, err=None) -> dict:
    """Run one cell once, print its result line and return the result.
    Raises BenchError, and prints no result, where the run must not
    report one."""
    t_start = time.perf_counter() if t_start is None else t_start
    out = out or sys.stdout
    err = err or sys.stderr
    bench = root / "benchmark"
    manifest = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = load_json(bench / "configs" / f"{cell['config']}.json")
    traffic = load_json(bench / "traffic" / f"{cell['traffic']}.json")
    section = "per_layer" if trace else "end_to_end"
    readers = {m["name"]: (m, load_reader(bench, m["name"]))
               for m in cell_metrics(manifest, workload, section)}

    from trico_tpu_torch.parallel import mesh_codec
    mesh = mesh_codec.make_mesh(cell["chips"], device=device)
    kind = torch.cuda.get_device_name(0) if device == "cuda" else device
    run = Run(cell, config, traffic, kind)

    # set-up: the libraries (their build, on a checkout's first run, is
    # reported apart as build_s), the pool, one write and read of each of
    # its meshes (entries 0 to n-1 are each mesh's first draw)
    t_build = time.perf_counter()
    _load_libraries(device)
    run.build_s = time.perf_counter() - t_build
    pool = [meshgen.make_streams(config, traffic["streams"], seed, k, bench)
            for k in range(meshgen.pool_size(config, traffic))]
    run.pool_raw_bytes = [_nbytes(p) for p in pool]
    program = program_cls(mesh, config["codec"])
    for k in range(len(meshgen.meshes(config))):
        program.read(program.write(pool[k]))
    if device == "cuda":
        torch.cuda.synchronize()

    spans = Spans() if trace else None
    run.spans = spans
    program.profile = spans
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()

    gen = np.random.default_rng([seed & meshgen.SEED_MASK, 7])
    distinct: dict[int, list[bytes]] = {}

    def keep_distinct(k: int, blob: bytes) -> bytes:
        # an archive equal to one already written for the same mesh is
        # dropped for that one, so the run holds each distinct archive once
        for b in distinct.setdefault(k, []):
            if b == blob:
                return b
        distinct[k].append(blob)
        return blob

    failed, reads, kept, n_reads = 0, [], [], 0
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    deadline = t0 + seconds
    i = 0
    with (spans.wrapping_decoders() if trace else contextlib.nullcontext()):
        while time.perf_counter() < deadline:
            k = i % len(pool)
            i += 1
            a = time.perf_counter()
            try:
                with (spans.request("write") if trace else contextlib.nullcontext()):
                    blob = program.write(pool[k])
            except Exception:
                failed += 1
                blob = None
                traceback.print_exc(file=err)
            b = time.perf_counter()
            if blob is not None:
                blob = keep_distinct(k, blob)
                run.archive_bytes.setdefault(k, len(blob))
            run.requests.append(Request("write", k, a, b, run.pool_raw_bytes[k], blob))
            if blob is None:
                continue
            a = time.perf_counter()
            try:
                with (spans.request("read") if trace else contextlib.nullcontext()):
                    res = program.read(blob)
            except Exception:
                failed += 1
                traceback.print_exc(file=err)
                run.requests.append(Request("read", k, a, time.perf_counter(), 0, None))
                continue
            b = time.perf_counter()
            run.requests.append(Request("read", k, a, b, _nbytes(res), blob))
            # every read at every STRIDE-th word; READ_SAMPLE reads whole,
            # a reservoir sample drawn from the seed
            reads.append((k, compare.strided(res, STRIDE)))
            n_reads += 1
            if len(kept) < READ_SAMPLE:
                kept.append((k, res))
            else:
                j = int(gen.integers(n_reads))
                if j < READ_SAMPLE:
                    kept[j] = (k, res)
            del res
    t1 = time.perf_counter()
    run.window_s = t1 - t0
    if device == "cuda":
        torch.cuda.synchronize()
        peak = max(torch.cuda.max_memory_allocated(d) for d in set(mesh.shards))
    else:
        peak = 0
    device_info = {"platform": "gpu" if device == "cuda" else device, "kind": kind,
                   "count": len(set(mesh.shards)), "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        prof.__exit__(None, None, None)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            run.trace = Trace.load(path)
        busy = float(np.sum(run.trace.busy_e - run.trace.busy_s))
        device_info.update({"busy_s": busy / device_info["count"], "window_s": run.window_s})
        breakdown = {"device_ops": run.trace.top_ops(10),
                     "idle_gaps": run.trace.idle_by_span(["write", "read"], 10)}
    found = _forbidden_modules()
    if found:
        raise BenchError(f"modules that the run must not load are loaded: {found}")

    del program
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = _check(run, pool, reads, kept, failed, err)
    print(f"run: {len(run.of('write'))} writes, {len(run.of('read'))} reads in "
          f"{run.window_s:.3f} s; set-up {run.setup_s:.3f} s, of it the libraries "
          f"{run.build_s:.3f} s; the check took "
          f"{time.perf_counter() - t_check:.3f} s", file=err)
    for kind in ("write", "read"):
        ms = [round((r.t1 - r.t0) * 1e3, 1) for r in run.of(kind)]
        if ms:
            print(f"{kind} ms: {ms}", file=err)
    attempted = len(run.requests)
    correct = attempted > 0 and all(
        c["value"] <= c["limit"] for c in checks.values() if "limit" in c)
    metrics = {}
    for name, (entry, read) in readers.items():
        value = read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": entry["unit"]}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["setup_build_s"] = run.build_s
    if device == "cuda":
        result["power"] = _power_limit()
    result["checks"] = checks
    for name, c in checks.items():
        if "limit" in c:
            print(f"check {name} {c['value']} limit {c['limit']}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return result

