"""Build, load and launch the hand-written Hopper kernels in ``csrc/``.

Each ``csrc/*.cu`` source is compiled at first use by ``nvcc`` into one shared
library per curve that needs it (``CURVE_SOURCES``: BW6-761 has no Fp2, so no
``g2.cu``) with a plain C interface
(``-gencode arch=compute_90a,code=sm_90a``, ``-DCURVE_<NAME>``: field.cuh
picks the moduli and the entry prefix), under
``build/gnark_icicle_tpu_torch/<hash of the sources>/`` at the root of the
checkout, and loaded with ``ctypes``. The (source, curve) pairs are built in
parallel processes. Every C entry point returns ``cudaGetLastError()`` after
its launch; :func:`check` raises on anything but 0.

Nothing here runs at import: the CPU tests import every module, and this
machine-independent part must not look for ``nvcc`` until a kernel is
launched on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build",
                          "gnark_icicle_tpu_torch")
SOURCES = ("fr.cu", "g1.cu", "g2.cu", "g1_reduce.cu", "g2_reduce.cu")
HEADER = "field.cuh"
# curve -> prefix of its C entry names (field.cuh ENTRY)
CURVES = {"bn254": "", "bls12_381": "bls12_381_", "bls12_377": "bls12_377_",
          "bw6_761": "bw6_761_"}
# curve -> the sources built for it; BW6-761's G2 lies over Fp and runs the
# g1 entries with its own b3 row. The reduction and Horner entries have
# sources of their own (g1_reduce, g2_reduce), so that nvcc builds them in
# processes beside the group's: the 12-word g2.cu alone was the build's
# longest process.
CURVE_SOURCES = {"bn254": ("fr", "g1", "g2", "g1_reduce", "g2_reduce"),
                 "bls12_381": ("fr", "g1", "g2", "g1_reduce", "g2_reduce"),
                 "bls12_377": ("fr", "g1", "g2", "g1_reduce", "g2_reduce"),
                 "bw6_761": ("fr", "g1", "g1_reduce")}

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
# argument types of every C entry point, by source (unprefixed names)
SIGNATURES = {
    "fr": {
        "fr_mont_mul": [_P, _P, _I64, _I32, _P, _I64, _P],
        "fr_sub": [_P, _P, _P, _I64, _P],
        "fr_add": [_P, _P, _P, _I64, _P],
        "plonk_quotient": [_P, _P, _P, _P, _I64, _P],
        "fr_batch_inv": [_P, _P, _I64, _P],
        "ntt_pass": [_P, _P, _P, _I64, _P, _P, _P, _I64, _P, _I64, _I64, _I32, _I32,
                     _I32, _I32, _I32, _P],
    },
    "g1": {
        "g1_add_mixed_masked": [_P, _I64, _I64, _P, _P, _P, _P, _P, _I32, _P],
        "g1_bucket_accumulate": [_P, _I64, _P, _P, _P, _P, _P, _P, _I32, _P],
        "g1_add": [_P, _I64, _P, _I64, _P, _I64, _I64, _P, _P],
        "g1_double": [_P, _I64, _P, _I64, _I64, _P, _P],
        "g1_fixed_base": [_P, _I64, _P, _I32, _I32, _I32, _P, _P, _P, _I32, _P],
        "g1_normalize": [_P, _I64, _P, _P, _I32, _P],
    },
    "g2": {
        "g2_add_mixed_masked": [_P, _I64, _I64, _P, _P, _P, _P, _P, _I32, _P],
        "g2_bucket_accumulate": [_P, _I64, _P, _P, _P, _P, _P, _P, _I32, _P],
        "g2_add": [_P, _I64, _P, _I64, _P, _I64, _I64, _P, _P],
        "g2_double": [_P, _I64, _P, _I64, _I64, _P, _P],
        "g2_fixed_base": [_P, _I64, _P, _I32, _I32, _I32, _P, _P, _P, _I32, _P],
        "g2_normalize": [_P, _I64, _P, _P, _I32, _P],
    },
    **{f"{g}_reduce": {
        f"{g}_bucket_reduce": [_P, _I64, _I32, _P, _P, _I32, _P],
        f"{g}_reduce_combine": [_P, _P, _I64, _I64, _I32, _I32, _P, _P, _I32, _P],
        f"{g}_horner": [_P, _I64, _I64, _I32, _P, _P, _I32, _P],
    } for g in ("g1", "g2")},
}

_libs: dict = {}
_lock = threading.Lock()
_build_lock = threading.Lock()


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in (HEADER,) + SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_stem(src: str, curve: str) -> str:
    """Name of the library built from ``csrc/<src>.cu`` for ``curve``."""
    return f"{src}_{curve}"


def libraries() -> list:
    """Every (source, curve) pair that is built, sources without ``.cu``."""
    return [(src, curve) for curve, srcs in CURVE_SOURCES.items() for src in srcs]


def build_dir() -> str:
    """The directory of this checkout's libraries (named by a hash of the
    sources)."""
    return os.path.join(BUILD_ROOT, _source_hash())


def built(curve: str) -> bool:
    """Whether every library of ``curve`` is in place (:func:`build` renames
    each into place when its nvcc ends, so a caller may poll this while a
    build runs in another thread)."""
    out_dir = build_dir()
    return all(os.path.exists(os.path.join(out_dir, f"lib{lib_stem(src, curve)}.so"))
               for src in CURVE_SOURCES[curve])


def build() -> str:
    """Compile every (source, curve) that has no library yet; returns the
    directory.

    The libraries land in a directory named by a hash of the sources, each
    written to a temporary name and renamed, so a half-built file is never
    loaded. ``-Xptxas -v`` output (registers, spills) goes to ``<stem>.log``
    and the wall seconds of each nvcc process to ``<stem>.seconds``. One
    build runs at a time: a second caller waits for the first and then
    finds the libraries in place.
    """
    with _build_lock:
        return _build()


def _build() -> str:
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src, curve in libraries():
        stem = lib_stem(src, curve)
        lib = os.path.join(out_dir, f"lib{stem}.so")
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", f"-DCURVE_{curve.upper()}", "-I", CSRC,
               "-o", tmp, os.path.join(CSRC, src + ".cu")]
        log = open(os.path.join(out_dir, f"{stem}.log"), "w")
        procs.append((subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT),
                      log, tmp, lib, stem, time.perf_counter()))
    failed = []
    while procs:  # poll, so that each library's seconds end when its nvcc does
        for entry in [e for e in procs if e[0].poll() is not None]:
            proc, log, tmp, lib, stem, t0 = entry
            procs.remove(entry)
            log.close()
            with open(os.path.join(out_dir, f"{stem}.seconds"), "w") as f:
                f.write(f"{time.perf_counter() - t0:.3f}\n")
            if proc.returncode != 0:
                failed.append(stem)
            else:
                os.replace(tmp, lib)
        time.sleep(0.1)
    if failed:
        logs = "\n".join(
            open(os.path.join(out_dir, f"{s}.log")).read() for s in failed)
        raise RuntimeError(f"nvcc failed on {failed}:\n{logs}")
    return out_dir


def load(curve: str) -> None:
    """Load the libraries of one curve, building first where one is missing
    (which builds them all, or waits for a build under way)."""
    with _lock:
        if all(lib_stem(src, curve) in _libs for src in CURVE_SOURCES[curve]):
            return
        out_dir = build_dir() if built(curve) else build()
        for src in CURVE_SOURCES[curve]:
            stem = lib_stem(src, curve)
            lib = ctypes.CDLL(os.path.join(out_dir, f"lib{stem}.so"))
            for name, argtypes in SIGNATURES[src].items():
                getattr(lib, CURVES[curve] + name).argtypes = argtypes
                getattr(lib, CURVES[curve] + name).restype = ctypes.c_int
            _libs[stem] = lib


def load_all() -> float:
    """Build (if needed) and load every library; returns the seconds spent."""
    t0 = time.perf_counter()
    for curve in CURVE_SOURCES:
        load(curve)
    return time.perf_counter() - t0


def fn(lib: str, name: str):
    """The C entry point ``name`` of library ``lib`` (building on first use)."""
    if lib not in _libs:
        load_all()
    return getattr(_libs[lib], name)


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")


# every kernel entry point by C symbol, for the smoke run's counts and checks
KERNELS: dict = {}


class Kernel:
    """One C entry point of one curve and the count of its launches.

    ``name`` is the entry's unprefixed name in ``csrc/<src>.cu``; the kernel
    is known by its C symbol, the curve's prefix plus that name. The count is
    a plain int that :meth:`launch` raises by one after each launch it made;
    a wrapper calls :meth:`launch` only on CUDA tensors, so the count says how
    often the main path really ran the kernel.
    """

    def __init__(self, src: str, curve: str, name: str, replaces: str):
        self.lib = lib_stem(src, curve)
        self.curve = curve
        self.name = CURVES[curve] + name
        self.source = f"gnark_icicle_tpu_torch/csrc/{src}.cu"
        self.replaces = replaces
        self.launches = 0
        KERNELS[self.name] = self

    def launch(self, *args) -> None:
        """Call the entry with ``args``, whose last is the launch's
        :func:`stream`: the launch runs with that stream's device current,
        whatever device the calling thread has current."""
        with torch.cuda.device(args[-1].device):
            check(fn(self.lib, self.name)(*args), self.name)
        self.launches += 1


def default_device() -> torch.device:
    """The first CUDA card; raises where torch sees none (the CPU runs only
    the plain versions, and only when a caller asks for it by name)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on an NVIDIA GPU; pass "
            "device='cpu' to run the plain PyTorch versions instead")
    return torch.device("cuda", 0)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; None means :func:`default_device`."""
    return default_device() if device is None else torch.device(device)


class LaunchStream:
    """The current stream of a tensor's device, as a kernel entry's last
    argument: ctypes passes its handle (``_as_parameter_``), and
    :meth:`Kernel.launch` makes its ``device`` current around the call, so
    that a launch on ``cuda:1`` from a thread whose current device is
    ``cuda:0`` runs on ``cuda:1``."""

    def __init__(self, device: torch.device):
        self.device = device
        self._as_parameter_ = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def stream(t: torch.Tensor) -> LaunchStream:
    return LaunchStream(t.device)


def is_cuda(*tensors) -> bool:
    """True when every tensor lies on a CUDA device, False when all are on
    the CPU; a mix raises (a wrapper never moves data between devices)."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on mixed devices: {sorted(kinds)}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
