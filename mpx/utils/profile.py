"""Per-phase benchmark profile (include/host/BenchmarkProfile.hpp analog).

Accumulates named timings into categories and renders a percentage report;
the driver pushes the same phase categories as the reference
(pre-computation, compute, post-computation).  Device work is timed with
``jax.block_until_ready`` at phase boundaries.
"""

from __future__ import annotations

import contextlib
import json
from collections import OrderedDict

from mpx.utils.timer import Timer


class BenchmarkProfile:
    def __init__(self, echo: bool = False):
        # category -> OrderedDict(name -> ns)
        self._categories: "OrderedDict[str, OrderedDict[str, int]]" = OrderedDict()
        #: print each push as it lands (a long run killed by a timeout
        #: still leaves its partial data)
        self.echo = echo

    def push(self, category: str, ns: int, name: str | None = None):
        entries = self._categories.setdefault(category, OrderedDict())
        key = name if name is not None else f"#{len(entries)}"
        entries[key] = entries.get(key, 0) + ns
        if self.echo:
            tag = f" {name}" if name is not None else ""
            print(f"[phase] {category}{tag}: {Timer.pretty(ns)}", flush=True)

    def total(self) -> int:
        return sum(sum(e.values()) for e in self._categories.values())

    def category_totals(self) -> "OrderedDict[str, int]":
        return OrderedDict(
            (cat, sum(entries.values())) for cat, entries in self._categories.items()
        )

    def report(self, file=None) -> str:
        """Category totals plus per-entry lines with in-category
        percentages, like the reference's BenchmarkProfile::Report
        (include/host/BenchmarkProfile.hpp:30-51) — e.g. the checkpoint
        path pushes one named entry per dispatch group."""
        total = max(self.total(), 1)
        lines = ["Benchmark profile:"]
        for cat, entries in self._categories.items():
            cat_ns = sum(entries.values())
            lines.append(
                f"  {cat}: {Timer.pretty(cat_ns)} ({100.0 * cat_ns / total:.2f}%)"
            )
            # Per-entry breakdown when the category has named entries or
            # more than one push.
            if len(entries) > 1 or any(not k.startswith("#") for k in entries):
                denom = max(cat_ns, 1)
                for name, ns in entries.items():
                    lines.append(
                        f"    {name}: {Timer.pretty(ns)} "
                        f"({100.0 * ns / denom:.2f}%)"
                    )
        lines.append(f"  Total: {Timer.pretty(self.total())}")
        text = "\n".join(lines)
        if file is not None:
            print(text, file=file)
        return text

    def as_json(self) -> str:
        return json.dumps(
            {
                cat: {"total_ns": sum(e.values()), "entries": dict(e)}
                for cat, e in self._categories.items()
            }
        )


@contextlib.contextmanager
def phase(profile: "BenchmarkProfile | None", category: str, name: str | None = None):
    """Time a phase into ``profile`` (no-op when profile is None)."""
    if profile is None:
        yield
        return
    t = Timer()
    try:
        yield
    finally:
        profile.push(category, t.elapsed(), name)
