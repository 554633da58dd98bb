"""Reduction of a ``torch.profiler`` trace of the profiled stretch to what
the per-layer metrics read: the device's busy seconds, the device time
under named host ranges and operators, the device operations that took
most time and the longest idle gaps by what the host was doing.

The idle arithmetic is the one ``chip_smoke.py:_profile`` uses (the device
is idle where no device operation runs, over the host-clock length of the
stretch), with busy time taken as the union of the device operations'
intervals, so that overlapping operations count once.
"""

from __future__ import annotations

from dataclasses import dataclass, field


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclass
class TraceSummary:
    """Seconds throughout. ``ranges`` and ``ops`` map a name (a range's
    exact name, an operator's name part) to the device seconds of the
    kernels launched under its outermost occurrences."""

    window_s: float
    busy_s: float
    ranges: dict = field(default_factory=dict)
    ops: dict = field(default_factory=dict)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    def device_s(self, ranges=(), ops=()) -> float | None:
        """Device seconds under the given ranges and operators together, or
        None where none of them ran."""
        found = [self.ranges[r] for r in ranges if self.ranges.get(r)]
        found += [self.ops[o] for o in ops if self.ops.get(o)]
        return sum(found) if found else None


def _is_device(e) -> bool:
    dt = getattr(e, "device_type", None)
    return dt is not None and getattr(dt, "name", str(dt)).upper() in ("CUDA", "PRIVATEUSE1")


def _outermost(events, match) -> list:
    """The events that ``match`` and have no matching host ancestor."""
    out = []
    for e in events:
        if not match(e):
            continue
        p = e.cpu_parent
        while p is not None and not match(p):
            p = p.cpu_parent
        if p is None:
            out.append(e)
    return out


def summarize(prof, window_s: float, range_names=(), op_names=(), top: int = 10) -> TraceSummary:
    events = list(prof.events())
    # a host range also appears on the device's timeline, spanning its
    # kernels and the gaps between them: not a device operation
    spans = set(range_names) | {e.name for e in events if not _is_device(e)
                                and e.name.startswith("qbench.")}
    dev = [e for e in events if _is_device(e) and e.name not in spans
           and not getattr(e, "is_user_annotation", False)]
    host = [e for e in events if not _is_device(e)]
    merged = _union([(e.time_range.start, e.time_range.end) for e in dev])
    busy_us = sum(e - s for s, e in merged)
    s = TraceSummary(window_s=window_s, busy_s=busy_us / 1e6)
    for name in range_names:
        hits = _outermost(host, lambda e, n=name: e.name == n)
        if hits:
            s.ranges[name] = sum(e.device_time_total for e in hits) / 1e6
    for part in op_names:
        hits = _outermost(host, lambda e, p=part: p in e.name)
        if hits:
            s.ops[part] = sum(e.device_time_total for e in hits) / 1e6
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e6
    s.device_ops = [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    labelled = []
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        cover = [e for e in host if e.time_range.start <= mid <= e.time_range.end]
        # the innermost host operation running at the gap's middle
        name = min(cover, key=lambda e: e.time_range.end - e.time_range.start).name if cover \
            else "host (no operation recorded)"
        labelled.append([name, (g1 - g0) / 1e6])
    s.idle_gaps = labelled
    return s
