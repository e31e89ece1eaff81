"""Measured cross-device communication accounting from compiled HLO.

The analytic `comm_stats()` formulas on the sharded steppers say what the
design *intends* to move; this module reports what the compiled program
*actually* contains. `hlo_collective_report` scans post-GSPMD optimized
HLO for collective ops (all-reduce, all-gather, reduce-scatter,
collective-permute, all-to-all) and sizes each one from its result shape,
so a silent re-replication (e.g. GSPMD deciding to all-gather an (n,3)
array the design meant to keep sharded) shows up as a fat collective in
the report instead of hiding behind a formula.

Byte counts are STATIC per-op sizes: an op inside a `fori_loop` body
appears once (XLA while loops aren't unrolled), so callers that want
per-step totals multiply by their known trip counts — see
`ShardedBandedStepper.measured_comm` / `SpmdSystem.measured_comm`. The
invariant the tests pin is the important one either way: every collective
in the compiled step is O(halo/cut) or scalar, never O(n).

There is no distributed runtime in the reference to mirror (its OpenMP
backend shares memory; SURVEY §2.7 derives the halo design from its
D/D^T reduction structure, System.cpp:54-62); this is the accounting
for it.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "collective-permute",
    "all-to-all",
)

# one HLO instruction: `%name = <shape> op-name(...)` where <shape> is a
# single array shape or a tuple of them
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_INSTR_RE = re.compile(
    r"=\s*(\([^)]*\)|\S+)\s+(" + "|".join(_COLLECTIVES) + r")(?:-start|-done)?\("
)


def _shape_bytes(shape_str: str) -> int:
    """Bytes of one `f32[8,128]`-style shape string or a `(a, b)` tuple."""
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue  # token[] etc.
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclass
class CollectiveOp:
    kind: str
    bytes: int
    shape: str
    line: str


def hlo_collective_report(hlo_text: str) -> dict:
    """Scan optimized HLO text for collectives.

    Returns {"ops": [CollectiveOp...], "static_bytes": int,
    "max_op_bytes": int, "counts": {kind: n}}. `-start`/`-done` pairs of
    async collectives are counted once (on the -start; the -done carries
    the same payload).
    """
    ops = []
    counts: dict[str, int] = {}
    for line in hlo_text.splitlines():
        if "-done(" in line:
            continue
        m = _INSTR_RE.search(line)
        if not m:
            continue
        shape_str, kind = m.group(1), m.group(2)
        b = _shape_bytes(shape_str)
        if "-start" in line:
            # Any async start's result tuple repeats operand+result (plus
            # u32[] context members) — summing would double-count the
            # payload. Size from the LARGEST single array shape: for
            # all-gather that's the gathered result, for collective-permute
            # and all-reduce operand==result, and it never picks a tiny
            # context scalar.
            shapes = _SHAPE_RE.findall(shape_str)
            if len(shapes) > 1:
                per = []
                for dt, dims in shapes:
                    if dt not in _DTYPE_BYTES:
                        continue
                    n = 1
                    for d in dims.split(","):
                        if d:
                            n *= int(d)
                    per.append(n * _DTYPE_BYTES[dt])
                if per:
                    b = max(per)
        ops.append(CollectiveOp(kind, b, shape_str, line.strip()[:160]))
        counts[kind] = counts.get(kind, 0) + 1
    return {
        "ops": ops,
        "static_bytes": sum(o.bytes for o in ops),
        "max_op_bytes": max((o.bytes for o in ops), default=0),
        "counts": counts,
    }


def compiled_hlo_text(jitted, *args, **kwargs) -> str:
    """Post-optimization (post-GSPMD) HLO of a jitted callable on the
    given args. Works on abstract args too (ShapeDtypeStruct)."""
    return jitted.lower(*args, **kwargs).compile().as_text()


def assert_no_fat_collectives(report: dict, limit_bytes: int,
                              what: str = "step") -> None:
    """Raise if any collective in `report` moves more than `limit_bytes`
    — the guard against silent GSPMD re-replication of O(n) state."""
    fat = [o for o in report["ops"] if o.bytes > limit_bytes]
    if fat:
        lines = "\n".join(f"  {o.kind} {o.bytes}B: {o.line}" for o in fat)
        raise AssertionError(
            f"{what}: {len(fat)} collective(s) exceed {limit_bytes} "
            f"bytes — O(n) traffic crept into the compiled program:\n"
            f"{lines}"
        )
