"""The program's own profiler ranges in a traced sub-window: the union of
the host spans of some ranges, clipped to the window, and the part of it
the card spent idle. Host spans and device intervals share the profiler's
clock, so an idle gap can be put down to what the host was doing."""

from __future__ import annotations


def union(trace, names) -> list:
    """The union of the host spans of the ranges `names`, clipped to the
    window, as sorted disjoint [start_us, end_us]."""
    w0, w1 = trace.window
    spans = sorted((max(s, w0), min(e, w1)) for n, s, e in trace.host_ops
                   if n in names and e > w0 and s < w1)
    out = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def length_us(intervals) -> float:
    return sum(b - a for a, b in intervals)


def idle_us(trace, intervals) -> float:
    """The part of the disjoint `intervals` (inside the window) in which
    the card ran nothing: their length less their overlap with the union of
    the device's intervals."""
    busy, i, overlap = trace.busy_intervals(), 0, 0.0
    for a, b in intervals:
        while i < len(busy) and busy[i][1] <= a:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < b:
            overlap += min(b, busy[j][1]) - max(a, busy[j][0])
            j += 1
    return length_us(intervals) - overlap


def ms_per_unit(trace, names, idle: bool = False):
    """Host ms a unit (chunk or step) inside the ranges `names`, or with
    `idle` the card's idle ms a unit inside them; None where the window
    holds none of them."""
    spans = union(trace, names)
    if not spans or not trace.units:
        return None
    us = idle_us(trace, spans) if idle else length_us(spans)
    return us / 1e3 / trace.units
