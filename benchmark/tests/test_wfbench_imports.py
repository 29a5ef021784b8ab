"""No run may load JAX or the JAX package; the reference loads nothing
of the program."""

import subprocess
import sys

import pytest

from benchmark.harness.device import forbidden_modules
from benchmark.harness.spec import ROOT


@pytest.mark.parametrize("mods, found", [
    (["wavefront_tpu_torch", "wavefront_tpu_torch.render.renderer",
      "numpy", "torch"], set()),
    (["jax"], {"jax"}),
    (["jax.numpy", "numpy"], {"jax"}),
    (["jaxlib.xla_client"], {"jaxlib"}),
    (["flax.linen"], {"flax"}),
    (["wavefront_tpu", "wavefront_tpu.core.config"], {"wavefront_tpu"}),
    (["wavefront_tpu_torch_extra", "jax_like", "jaxx"], set()),
])
def test_top_level_names_compared_whole(mods, found):
    assert forbidden_modules(mods) == found


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True).stdout
    return set(out.split())


def test_reference_imports_nothing_of_the_program():
    mods = loaded_after(
        "import benchmark.reference.render, benchmark.reference.world, "
        "benchmark.reference.lights, benchmark.harness.check")
    assert not mods & {"wavefront_tpu_torch", "wavefront_tpu", "jax",
                       "jaxlib", "flax"}


def test_a_run_loads_no_jax():
    """A whole run on the CPU at a small size loads the port and no JAX."""
    code = (
        "import time\n"
        "from benchmark.harness import main as M\n"
        "a = M.parse(['--workload', 'streamed.orbit', '--seed', '5', "
        "'--seconds', '0.5', '--trace', '0'])\n"
        "M.run(a, '.', time.perf_counter(), device='cpu', "
        "sizes={'width': 16, 'height': 8}, traffic={'check_pixels': 64, "
        "'warm_images': 1})\n")
    mods = loaded_after(code)
    assert "wavefront_tpu_torch" in mods
    assert not forbidden_modules(mods)
