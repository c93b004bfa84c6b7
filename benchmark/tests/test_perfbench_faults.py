"""``correct`` comes out false for the control and for each fault the
cells can have, planted under the harness's own run; and true for the
program as it is. (Each cell runs on one card with one shard, so the
fault of an exchange between cards left out cannot arise.)"""

import numpy as np
import pytest

from benchmark import harness
from benchmark.control import control_program
from conftest import REPO

CELLS = [w["name"] for w in harness.load_json(REPO / "BENCHMARK.json")["workloads"]]


class Stale(harness.Program):
    """Each request returns the previous request's answer."""

    def write(self, streams):
        blob, self.last_blob = getattr(self, "last_blob", None), super().write(streams)
        return blob or self.last_blob

    def read(self, blob):
        out, self.last_out = getattr(self, "last_out", None), super().read(blob)
        return out or self.last_out


class Half(harness.Program):
    """Half of each stream left out: written from the first half, read
    back with the second half zeroed."""

    def write(self, streams):
        return super().write({k: v[: len(v) // 2] if k != "triangles" else v
                              for k, v in streams.items()})

    def read(self, blob):
        out = super().read(blob)
        for v in out.values():
            v[len(v) // 2:] = 0
        return out


class AlteredArchive(harness.Program):
    """One byte of each archive altered where it is produced."""

    def write(self, streams):
        blob = bytearray(super().write(streams))
        blob[len(blob) // 2] ^= 0x21
        return bytes(blob)


class AlteredRead(harness.Program):
    """One word of each read altered where it is produced."""

    def read(self, blob):
        out = super().read(blob)
        v = out["vertices"].reshape(-1).view(np.uint32)
        v[len(v) // 3] ^= 1
        return out


def _run(root, cell, program_cls):
    return harness.run_cell(root, cell, 2**32 + 3, 0.3, False, device="cpu",
                            program_cls=program_cls)


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_as_it_is_is_correct_and_the_control_is_not(tiny_root, cell):
    assert _run(tiny_root, cell, harness.Program)["correct"]
    res = _run(tiny_root, cell, control_program(harness.Program))
    assert not res["correct"]
    assert res["checks"]["read_words_wrong"]["value"] > 0
    assert res["checks"]["archive_words_wrong"]["value"] > 0


@pytest.mark.parametrize("fault", [Stale, Half, AlteredArchive, AlteredRead],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_every_fault_is_not_correct(tiny_root, cell, fault):
    res = _run(tiny_root, cell, fault)
    assert not res["correct"], res["checks"]
