"""The output check's numbers and the result line.

Every number compared has an upper limit it may not pass.  A run prints
each beside its limit as the last lines of standard error, and the result,
one JSON object, as the last line of standard output, with the numbers
under ``checks``, its last key.
"""

from __future__ import annotations

import json
import math
import sys


class Checks:
    """Numbers compared against their limits, in the order they were added."""

    def __init__(self):
        self.items: dict[str, dict] = {}

    def add(self, name: str, value: float, limit: float) -> None:
        self.items[name] = {"value": float(value), "limit": float(limit)}

    @property
    def passed(self) -> bool:
        return bool(self.items) and all(
            math.isfinite(c["value"]) and c["value"] <= c["limit"]
            for c in self.items.values())

    def lines(self) -> list[str]:
        return [f"check {n}: {c['value']!r} (limit {c['limit']!r})"
                for n, c in self.items.items()]


def emit(*, checks: Checks, attempted: int, failed: int, metrics: dict,
         device: dict, breakdown: dict | None = None) -> dict:
    """Print the check lines to stderr and the result line to stdout."""
    result = {"correct": checks.passed and failed == 0, "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks.items
    sys.stdout.flush()
    for line in checks.lines():
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return result

