"""The check fails the control and each fault a cell can have; the
sound program passes it.  On the CPU at 32x18 (the kernels' plain
versions), on the whole 416x96x416 window."""

import pytest

from benchmark.tests._runs import cpu_run

CELLS = ["streamed.orbit", "streamed.still"]


def stale(system):
    """A step that returns its state unchanged: every image the first."""
    frame, held = system.frame, []

    def f(yaw, fc, k):
        img, aux = frame(yaw, fc, k)
        held.append(img)
        return held[0], aux

    system.frame = f


def half_left_out(system):
    """Half of the rays left out: every other pixel never rendered."""
    frame = system.frame

    def f(yaw, fc, k):
        img, aux = frame(yaw, fc, k)
        img = img * 1
        img.reshape(-1, 3)[1::2] = 0.0
        return img, aux

    system.frame = f


def altered(system):
    """An answer altered where it is produced: radiance off by 1%."""
    frame = system.frame

    def f(yaw, fc, k):
        img, aux = frame(yaw, fc, k)
        return img * 1.01, aux

    system.frame = f


def truncated(system):
    """A frame whose audit reports truncated rays."""
    frame = system.frame

    def f(yaw, fc, k):
        img, aux = frame(yaw, fc, k)
        return img, {**aux, "truncated": 3}

    system.frame = f


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_passes(cell):
    res = cpu_run(cell)
    assert res["correct"], res["check"]
    # a ray that grazes an edge may part float32 from float64 on one
    # pixel of the small frame's lit ~150: far under the limit
    assert all(c["value"] < c["limit"] / 5 for c in res["check"].values())


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [stale, half_left_out, altered, truncated])
def test_fault_fails(cell, fault):
    res = cpu_run(cell, seconds=1.5, fault=fault)
    assert not res["correct"], (fault.__name__, res["check"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    """The control: the program's bfloat16 color pipeline, the precision
    below the configuration's float32."""
    res = cpu_run(cell, settings={"shade_bf16": True})
    assert not res["correct"]
    assert res["check"]["off_share"]["value"] > 0.5
