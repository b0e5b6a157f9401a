"""Constraint profiler: attribute constraint counts to source locations.

Role parity: reference profile/ — ``profile.Start()`` collects a sample per
added constraint with the caller stack, sample value = constraints added
(profile/profile.go:71-105; recorded from constraint/core.go:348,365). Here
``start()`` arms a process-global collector; every builder ``add_r1c``/
``add_gate`` records the defining Python frame stack; ``top()`` prints the
hot spots and ``dump_pprof_like()`` emits a flat text profile.

Copied from gnark_icicle_tpu/profile/__init__.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_copies.py holds it to the original. Its
device-trace hooks (``device_trace``, ``annotate``) wrap the JAX profiler
and are left out.
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
