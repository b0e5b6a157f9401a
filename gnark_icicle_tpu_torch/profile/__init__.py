"""Constraint profiler: attribute constraint counts to source locations.

Role parity: reference profile/ — ``profile.Start()`` collects a sample per
added constraint with the caller stack, sample value = constraints added
(profile/profile.go:71-105; recorded from constraint/core.go:348,365). Here
``start()`` arms a process-global collector; every builder ``add_r1c``/
``add_gate`` records the defining Python frame stack; ``top()`` prints the
hot spots and ``dump_pprof_like()`` emits a flat text profile.

Copied from gnark_icicle_tpu/profile/__init__.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_copies.py holds it to the original. Its
device-trace hooks (``device_trace``, ``annotate``, :172-201) are ported onto
``torch.profiler``: a Chrome/Perfetto trace of the CPU and CUDA activity
of a region, and named regions in it.
"""

from __future__ import annotations

import traceback
from collections import Counter
from dataclasses import dataclass, field

_ACTIVE: list = []


@dataclass
class Profile:
    name: str = "constraints"
    by_site: Counter = field(default_factory=Counter)
    by_stack: Counter = field(default_factory=Counter)
    by_frames: Counter = field(default_factory=Counter)
    total: int = 0

    def record(self, n: int = 1):
        frames = [
            (fr.name, fr.filename, fr.lineno)
            for fr in traceback.extract_stack()
            if "gnark_icicle_tpu" not in fr.filename
            and "profile/__init__" not in fr.filename
        ]
        if frames:
            stack = [
                f"{name} ({fn.rsplit('/', 1)[-1]}:{ln})"
                for name, fn, ln in frames
            ]
            self.by_site[stack[-1]] += n
            self.by_stack[" > ".join(stack[-4:])] += n
            # leaf-first full stacks for the pprof emitter (capped depth)
            self.by_frames[tuple(reversed(frames[-32:]))] += n
        self.total += n

    def top(self, n: int = 10) -> str:
        """Flat top-N report (≙ p.Top())."""
        lines = [f"total constraints: {self.total}"]
        for site, cnt in self.by_site.most_common(n):
            pct = 100.0 * cnt / max(self.total, 1)
            lines.append(f"{cnt:>10}  {pct:5.1f}%  {site}")
        return "\n".join(lines)

    def stop(self) -> "Profile":
        if self in _ACTIVE:
            _ACTIVE.remove(self)
        return self

    def dump_pprof_like(self, path: str) -> None:
        """Flat text profile (site  count  percent per line) — the quick
        human-readable dump; for standard tooling use dump_pprof()."""
        with open(path, "w") as f:
            f.write(self.top(n=len(self.by_site)) + "\n")

    def dump_pprof(self, path: str) -> None:
        """Write a REAL pprof profile (gzipped profile.proto), consumable
        by `go tool pprof` / pprof web UIs — format parity with the
        reference's profile output (profile/profile.go:71-105,160 writes
        google/pprof profiles via profile.Write). Samples are full
        leaf-first call stacks, value = constraints added.

        The protobuf is hand-encoded (wire format: varint tags + length-
        delimited submessages) — no protoc dependency; field numbers from
        github.com/google/pprof/proto/profile.proto."""
        import gzip

        strings: dict = {"": 0}

        def sid(s: str) -> int:
            if s not in strings:
                strings[s] = len(strings)
            return strings[s]

        def varint(v: int) -> bytes:
            out = bytearray()
            while True:
                b = v & 0x7F
                v >>= 7
                out.append(b | (0x80 if v else 0))
                if not v:
                    return bytes(out)

        def tag(field_no: int, wire: int) -> bytes:
            return varint((field_no << 3) | wire)

        def f_varint(field_no: int, v: int) -> bytes:
            return tag(field_no, 0) + varint(v)

        def f_msg(field_no: int, payload: bytes) -> bytes:
            return tag(field_no, 2) + varint(len(payload)) + payload

        # functions and locations, deduped per (name, file, line)
        functions: dict = {}   # (name, file) -> id
        locations: dict = {}   # (name, file, line) -> id

        def loc_id(frame) -> int:
            if frame not in locations:
                name, fn, ln = frame
                fkey = (name, fn)
                if fkey not in functions:
                    functions[fkey] = len(functions) + 1
                locations[frame] = len(locations) + 1
            return locations[frame]

        samples = b""
        for frames, count in self.by_frames.items():
            body = b""
            for fr in frames:  # leaf first, as pprof requires
                body += f_varint(1, loc_id(fr))
            body += f_varint(2, count)
            samples += f_msg(2, body)

        func_msgs = b""
        for (name, fn), fid in functions.items():
            body = (f_varint(1, fid) + f_varint(2, sid(name))
                    + f_varint(3, sid(name)) + f_varint(4, sid(fn)))
            func_msgs += f_msg(5, body)

        loc_msgs = b""
        for (name, fn, ln), lid in locations.items():
            line = f_varint(1, functions[(name, fn)]) + f_varint(2, ln)
            body = f_varint(1, lid) + f_msg(4, line)
            loc_msgs += f_msg(4, body)

        # sample_type: one ValueType {type: name, unit: "count"}
        st = f_msg(1, f_varint(1, sid(self.name)) + f_varint(2, sid("count")))

        str_table = b"".join(
            f_msg(6, s.encode()) for s in
            sorted(strings, key=strings.get)
        )
        profile = st + samples + loc_msgs + func_msgs + str_table
        with gzip.open(path, "wb") as f:
            f.write(profile)


def start(name: str = "constraints") -> Profile:
    p = Profile(name)
    _ACTIVE.append(p)
    return p


def record_constraint(n: int = 1):
    """Called by builders on every constraint (no-op when not profiling,
    ≙ profile.RecordConstraint at constraint/core.go:348)."""
    for p in _ACTIVE:
        p.record(n)


def is_profiling() -> bool:
    return bool(_ACTIVE)


# ---------------------------------------------------------------------------
# device-kernel tracing on torch.profiler (≙ the reference's zerolog
# Dur("took") prover timing, at kernel granularity)
# ---------------------------------------------------------------------------

import contextlib
import os


class DeviceTrace:
    """What :func:`device_trace` recorded: ``device``, the torch device it
    traced, and ``path``, the trace file it wrote (None until the region
    has ended)."""

    def __init__(self, device):
        self.device = device
        self.path = None


@contextlib.contextmanager
def device_trace(log_dir: str, device=None):
    """Record the CPU activity and, on a CUDA device, the CUDA activity of a
    region with torch.profiler, and write it into ``log_dir`` as a
    Chrome/Perfetto trace (``<host>_<pid>.<ns>.pt.trace.json``, the name
    TensorBoard's profiler plugin reads). ``device`` is resolved as every
    entry point's is: the first CUDA card unless the caller names another
    (``"cpu"`` records the CPU only).

    Usage::

        with profile.device_trace("/tmp/trace") as trace:
            with profile.annotate("request"):
                groth16.prove(...)
        trace.path   # the file

    On a CUDA device it raises RuntimeError, and leaves no trace file, where
    torch.profiler cannot record CUDA activity or recorded none in the
    region (no kernel, copy or memset event): a CPU-only trace of a device
    region would hide the kernels.

    A later session of a process can miss the kernels of its first
    seconds. Torch 2.11's profiler keeps CUPTI attached from one session to
    the next, and under host load a later session then drops more of them
    the longer the process has profiled (``trace_probe.py``).
    ``TEARDOWN_CUPTI=1``, set before torch is imported, detaches CUPTI after
    each session, and every session keeps its kernels; but the process then
    hangs in the interpreter's finalization, so a program that sets it ends
    with ``os._exit``, as ``chip_smoke.py`` does.
    """
    import json
    import socket
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..ops.cuda import resolve_device

    trace = DeviceTrace(resolve_device(device))
    on_cuda = trace.device.type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_cuda:
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("torch.profiler cannot record CUDA activity here")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield trace
        if on_cuda:
            torch.cuda.synchronize(trace.device)
    path = os.path.join(
        log_dir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    if on_cuda:
        with open(path) as f:
            cats = {e.get("cat") for e in json.load(f)["traceEvents"]}
        if not cats & {"kernel", "gpu_memcpy", "gpu_memset"}:
            os.remove(path)
            raise RuntimeError("torch.profiler recorded no CUDA activity in the traced region")
    trace.path = path


@contextlib.contextmanager
def annotate(name: str):
    """A named region inside a device trace (≙ jax.profiler.TraceAnnotation):
    a torch.profiler ``record_function`` and, where a CUDA card is present,
    an NVTX range of the same name."""
    import torch

    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield
