"""The check of `lamps.orbit` (the lamp-lit window, the general shade path
with the stochastic light walk) fails the control and each fault, and
passes the sound program.  On the CPU at 32x18 (the kernels' plain
versions), on the whole 416x96x416 window; the reference's scene is
built once for the file."""

import functools
import os

import pytest

from benchmark.harness import check, spec
from benchmark.tests._runs import cpu_run
from benchmark.tests.test_wfbench_faults import (altered, half_left_out,
                                                 stale, truncated)

CELL = "lamps.orbit"
# the plain versions take 0.6-3 s an image at 32x18; a stale image shows
# from the second image on
SECONDS = {"stale": 10.0}


def nee_overflow(system):
    """A frame whose audit reports rays whose light crossings overflowed
    the sparse NEE sweep's slots."""
    frame = system.frame

    def f(yaw, fc, k):
        img, aux = frame(yaw, fc, k)
        return img, {**aux, "nee_overflow": 2}

    system.frame = f


@pytest.fixture(scope="module")
def scene():
    cell = spec.load_cell(CELL)
    return cell.build.reference(cell.config,
                                os.path.join(spec.ROOT, "assets"), "cpu")


@pytest.fixture
def run(scene, monkeypatch):
    monkeypatch.setattr(check, "compare",
                        functools.partial(check.compare, scene=scene))
    return functools.partial(cpu_run, CELL)


def test_sound_program_passes(run):
    res = run()
    assert res["correct"], res["check"]
    assert all(c["value"] < c["limit"] / 5 for c in res["check"].values())


@pytest.mark.parametrize("fault", [stale, half_left_out, altered, truncated,
                                   nee_overflow])
def test_fault_fails(run, fault):
    res = run(seconds=SECONDS.get(fault.__name__, 1.5), fault=fault)
    if fault is stale:
        assert res["attempted"] >= 2
    assert not res["correct"], (fault.__name__, res["check"])


def test_control_fails(run):
    """The control: the program's bfloat16 color pipeline, the precision
    below the configuration's float32."""
    res = run(settings={"shade_bf16": True})
    assert not res["correct"]
    assert res["check"]["off_share"]["value"] > 0.5
