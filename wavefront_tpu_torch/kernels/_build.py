"""Build and load the package's CUDA kernels.

Each `csrc/<name>.cu` exports plain C functions (no PyTorch headers) and
is compiled by `nvcc` into its own shared library under
`build/wavefront_tpu_torch/` at the repository root, named by a hash of
its source, the `csrc/` headers it includes (`#include "light_bvh.cuh"`)
and its flags, and loaded with `ctypes`.  `build_all()` starts one
`nvcc` per source at once and waits for all of them.

Flags: `sm_90a` (Hopper), `-O3`, and `-fmad=false` — contracting a*b+c
into one fused multiply-add moves crossing times by an ulp, which flips
coplanar voxel ties against the plain PyTorch tracer.  No fast math:
division, square root and the transcendental functions stay IEEE-accurate.
`-Xptxas=-v` makes the assembler report each kernel's registers, spills
and shared memory; the report is kept beside the library
(`resource_usage`).

A missing `nvcc` or a failed build raises; nothing falls back.

`load_host` builds a plain C++ source of `csrc/` (the native worldgen)
with the host compiler the same way: `-O3 -std=c++17`, no
`-march=native` (the library must not depend on the machine that built
it) and `-ffp-contract=off` (its float64 arithmetic stays the NumPy
version's, operation for operation).

`validation_layer(nan_checks=True)` (`utils/validation.py`) sees every
tensor op through a dispatch mode, but no `ctypes` launch, so each
wrapper hands its outputs to `check_outputs` after its launch, and runs
a kernel's plain version (CPU tensors) through `plain`, which the mode
sees as one op, as it sees the kernel on the card.  With no such context
open both cost one read of a module flag.  The frame kernels K1-K3 do
this; the lab probes K4-K7 run under no such context.

Every wrapper launches through a `Launcher`: the C function typed and
bound once, called on its tensors' device with the raw handle of
PyTorch's current stream there.  A kernel of a few microseconds costs
what its host path costs, so the path holds no per-call library lookup,
builds no `torch.cuda.Stream`, and switches the current device only when
the tensors lie on another one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

import torch

from wavefront_tpu_torch.utils import spans

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "wavefront_tpu_torch")
SOURCES = ("window_trace", "shade", "texel", "radix_hist", "device_probe",
           "extract_probe", "loop_probe", "ray_sort", "nee_sweep",
           "light_walk", "tri_sweep")
HOST_FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-fPIC", "-shared")
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


def _lib_path(name: str, ext: str = ".cu", flags=NVCC_FLAGS) -> str:
    with open(os.path.join(CSRC, name + ext), "rb") as f:
        src = f.read()
    for header in re.findall(rb'^#include "([^"]+)"', src, re.M):
        with open(os.path.join(CSRC, header.decode()), "rb") as f:
            src += f.read()
    h = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
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


def host_compiler() -> str:
    """The host C++ compiler: $CXX, then c++ and g++ on PATH."""
    for c in (os.environ.get("CXX"), "c++", "g++"):
        found = shutil.which(c) if c else None
        if found:
            return found
    raise RuntimeError("no host C++ compiler ($CXX, c++ or g++ on PATH); "
                       "the native worldgen cannot be built")


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of the host source `csrc/<name>.cpp`, built
    with the host compiler on first use."""
    with _lock:
        if name not in _libs:
            out = _lib_path(name, ".cpp", HOST_FLAGS)
            if not os.path.exists(out):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{out}.{os.getpid()}.tmp"
                p = subprocess.run(
                    [host_compiler(), *HOST_FLAGS, "-o", tmp,
                     os.path.join(CSRC, name + ".cpp")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                if p.returncode != 0:
                    raise RuntimeError(f"the host compiler failed for "
                                       f"{name}.cpp:\n"
                                       f"{p.stdout.decode(errors='replace')}")
                os.replace(tmp, out)
            _libs[name] = ctypes.CDLL(out)
        return _libs[name]


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
                k = re.search(r"\d((?:[a-z]+_)*kernel)((?:I(?:L[a-z]-?\d+E)+E)?)",
                              mangled)
                args = re.findall(r"L[a-z](-?\d+)E", k.group(2)) if k else []
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


# the ctypes type of each letter of a Launcher's signature
ARG_TYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "u": ctypes.c_uint,
             "f": ctypes.c_float}


class Launcher:
    """The C launch function `fn` of `csrc/<lib>.cu`, called on the
    caller's current CUDA stream.

    `signature` names the function's parameters before its last, one
    letter each (ARG_TYPES: p a pointer, passed as an int, None or a
    ctypes array, i an int, u an unsigned int, f a float); the last
    parameter is the stream.  The library is built and the function
    typed on the first call; later calls go straight to it.

    `launcher(device, *args)` calls `fn(*args, stream)` on CUDA device
    index `device`, with the handle of PyTorch's current stream there,
    read by `torch._C._cuda_getCurrentRawStream` (the call PyTorch's own
    generated code makes) without building a `torch.cuda.Stream`, and
    returns the function's `cudaError`: 0, or one listed in `returned`;
    any other raises.  The launch goes to `device`: when another device
    is current, `device` is made current for the call and the old one
    restored after it; when it is current already, nothing switches (one
    compare of device indices, `torch._C._cuda_getDevice`).  With one
    card visible its device is the current one, and nothing is asked.  A
    guard in C, a device argument that each entry point makes current,
    measured no cheaper: ctypes takes as long to pass the int as Python
    takes to ask for the device (PERF.md)."""

    def __init__(self, lib: str, fn: str, signature: str, what: str,
                 returned: tuple = ()):
        if any(c not in ARG_TYPES for c in signature):
            raise ValueError(f"Launcher {fn}: signature {signature!r} has "
                             f"letters outside {''.join(ARG_TYPES)}")
        self.lib, self.fn, self.signature = lib, fn, signature
        self.what, self.returned = what, tuple(returned)
        self._call = self._stream = None
        self._get_device = self._set_device = None
        self._one_card = False

    def bind(self):
        """Build and load the library and type the function; returns the
        typed function."""
        if self._call is None:
            f = getattr(load(self.lib), self.fn)
            f.argtypes = [ARG_TYPES[c] for c in self.signature] + [
                ctypes.c_void_p]
            f.restype = ctypes.c_int
            self._stream = torch._C._cuda_getCurrentRawStream
            self._get_device = torch._C._cuda_getDevice
            self._set_device = torch._C._cuda_setDevice
            self._one_card = torch.cuda.device_count() == 1
            self._call = f
        return self._call

    def __call__(self, device: int, *args) -> int:
        call = self._call or self.bind()
        current = device if self._one_card else self._get_device()
        if current == device:
            err = call(*args, self._stream(device))
        else:
            self._set_device(device)
            try:
                err = call(*args, self._stream(device))
            finally:
                self._set_device(current)
        if err and err not in self.returned:
            raise RuntimeError(
                f"{self.what}: CUDA launch failed (cudaError {err})")
        return err


# open validation_layer(nan_checks=True) contexts, and the plain versions
# running inside one (the mode leaves their ops to `plain`'s check)
_nan_checks = 0
_in_plain = 0


def set_nan_checks(on: bool) -> None:
    """Open (True) or close (False) one NaN-checking context."""
    global _nan_checks
    _nan_checks += 1 if on else -1


def nan_checks_paused() -> bool:
    """Whether a kernel's plain version is running under `plain`."""
    return _in_plain > 0


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for x in out:
            yield from _tensors(x)


def check_outputs(what: str, out) -> None:
    """Raise FloatingPointError when a NaN-checking context is open and
    a floating tensor of `out` (a tensor, or tuples of them) holds a
    NaN; `what` names the kernel.  Each tensor's test is a host sync
    (`sync.nan_check`)."""
    if not _nan_checks:
        return
    for t in _tensors(out):
        if not t.is_floating_point():
            continue
        with spans.host_sync("sync.nan_check"):
            nan = bool(torch.isnan(t).any())
        if nan:
            raise FloatingPointError(
                f"invalid value (nan) encountered in {what}")


def plain(what: str, fn, *args, **kw):
    """`fn(*args, **kw)`, a kernel's plain version: with a NaN-checking
    context open its ops go unchecked and its outputs are checked as the
    kernel's (`check_outputs`), so the CPU run reports what the card's
    run reports."""
    global _in_plain
    if not _nan_checks:
        return fn(*args, **kw)
    _in_plain += 1
    try:
        out = fn(*args, **kw)
    finally:
        _in_plain -= 1
    check_outputs(what, out)
    return out
