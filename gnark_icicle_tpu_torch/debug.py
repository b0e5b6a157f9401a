"""Debug-mode constraint provenance (source stack traces).

Role parity: reference debug/ (debug.go:27-83 — with ``-tags=debug`` every
constraint records the caller stack, and unsatisfied-constraint errors print
it, constraint/bn254/solver.go:628-649). The build-tag analog here is the
``GNARK_TPU_DEBUG=1`` env var or ``set_debug(True)`` before compiling;
capture is off by default because it costs a stack walk per constraint.

Copied from gnark_icicle_tpu/debug.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_copies.py holds it to the original. The
frame filter names the port's own directories.
"""

from __future__ import annotations

import os
import traceback

_enabled = os.environ.get("GNARK_TPU_DEBUG", "") not in ("", "0")


def set_debug(on: bool) -> None:
    global _enabled
    _enabled = on


def is_debug() -> bool:
    return _enabled


_SKIP_SUBSTRINGS = (
    "gnark_icicle_tpu_torch/frontend/",
    "gnark_icicle_tpu_torch/constraint/",
    "gnark_icicle_tpu_torch/debug.py",
)


def capture_stack(limit: int = 6) -> str | None:
    """Short user-frame stack summary ("file:line in fn"), innermost last.

    Frames inside the framework's builder/IR plumbing are filtered so the
    trace points at circuit code (≙ debug.Stack's runtime.Callers filter).
    """
    if not _enabled:
        return None
    frames = traceback.extract_stack()[:-1]
    user = [
        f for f in frames
        if not any(s in f.filename.replace("\\", "/")
                   for s in _SKIP_SUBSTRINGS)
    ]
    tail = user[-limit:]
    return " <- ".join(
        f"{os.path.basename(f.filename)}:{f.lineno} in {f.name}"
        for f in reversed(tail)
    ) or None
