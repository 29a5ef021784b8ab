"""Build and load the package's CUDA kernels.

Each `csrc/<name>.cu` exports plain C functions (no PyTorch headers) and
is compiled by `nvcc` into its own shared library under
`build/wavefront_tpu_torch/` at the repository root, named by a hash of
its source and flags, and loaded with `ctypes`.  `build_all()` starts one
`nvcc` per source at once and waits for all of them.

Flags: `sm_90a` (Hopper), `-O3`, and `-fmad=false` — contracting a*b+c
into one fused multiply-add moves crossing times by an ulp, which flips
coplanar voxel ties against the plain PyTorch tracer.  No fast math:
division, square root and the transcendental functions stay IEEE-accurate.
`-Xptxas=-v` makes the assembler report each kernel's registers, spills
and shared memory; the report is kept beside the library
(`resource_usage`).

A missing `nvcc` or a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "wavefront_tpu_torch")
SOURCES = ("window_trace", "shade", "texel", "radix_hist", "device_probe",
           "extract_probe", "loop_probe")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then
    /usr/local/cuda/bin/nvcc."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        src = f.read()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{h}.so")


def build_all() -> None:
    """Compile every missing library in parallel and load all of them."""
    with _lock:
        todo = [n for n in SOURCES if n not in _libs]
        procs = []
        for n in todo:
            out = _lib_path(n)
            if os.path.exists(out):
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, n + ".cu")]
            procs.append((n, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for n, out, tmp, p in procs:
            log = p.communicate()[0].decode(errors="replace")
            if p.returncode != 0:
                errors.append(f"nvcc failed for {n}.cu:\n{log}")
            else:
                with open(out + ".log", "w") as f:
                    f.write(log)
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        for n in todo:
            _libs[n] = ctypes.CDLL(_lib_path(n))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    if name not in _libs:
        build_all()
    return _libs[name]


def library_path(name: str) -> str:
    """The file of the built library of `csrc/<name>.cu` (built on first
    use), for tools that read the compiled code."""
    load(name)
    return _lib_path(name)


def resource_usage(name: str) -> list:
    """The assembler's report for each kernel of `csrc/<name>.cu` (built
    on first use): [{"kernel", "registers", "spill_stores", "spill_loads",
    "stack", "smem"}], byte counts as `ptxas -v` prints them, each kernel
    named with its template arguments (`shade_kernel<8,0>`)."""
    path = library_path(name) + ".log"
    if not os.path.exists(path):
        return []
    out, cur = [], None
    with open(path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                mangled = m.group(1)
                k = re.search(r"\d((?:[a-z]+_)*kernel)((?:I(?:L[ib]-?\d+E)+E)?)",
                              mangled)
                args = re.findall(r"L[ib](-?\d+)E", k.group(2)) if k else []
                cur = {"kernel": (k.group(1) + (f"<{','.join(args)}>"
                                                if args else ""))
                       if k else mangled}
                out.append(cur)
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                cur["stack"], cur["spill_stores"], cur["spill_loads"] = (
                    int(v) for v in m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                cur["smem"] = int(sm.group(1)) if sm else 0
    return out


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch wrapper."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {err})")
