"""The profiler's trace of a window reduced to what the per-layer metrics
read: the window's length, the seconds in which a kernel ran (the union
of the kernels' intervals), each kernel class's and name's seconds, and
the idle gaps labelled by what the host was doing (the innermost host
range open where a gap starts).

A trace that holds no device kernel, or fewer of the port's attention
kernels than the program's launch counter says ran, missed launches:
:func:`summarize` raises :class:`TraceMissed` rather than read it as an
idle card.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

from .kernel_classes import classify


class TraceMissed(RuntimeError):
    pass


def _union(spans: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """-> (covered length, the gaps between covered stretches)."""
    covered, gaps, end = 0.0, [], None
    for a, b in sorted(spans):
        if end is None:
            covered, end = b - a, b
            continue
        if a > end:
            gaps.append((end, a))
        if b > end:
            covered += b - max(a, end)
            end = b
    return covered, gaps


def summarize(events, window_name: str, expect: Dict[str, int]) -> Dict:
    """``events``: ``torch.profiler``'s ``prof.events()``; ``window_name``
    the ``record_function`` range of the window; ``expect``: {kernel
    class: least kernels the launch counter says ran}.  Times in the
    result are seconds."""
    from torch.autograd import DeviceType

    window = None
    kernels, host = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # a ``record_function`` range is mirrored on the device's
            # timeline: an annotation, not a kernel
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith("portbench.")):
                kernels.append((a, b, e.name))
        elif e.name == window_name:
            window = (a, b)
        else:
            host.append((a, b, e.name))
    if window is None:
        raise TraceMissed(f"the trace holds no {window_name!r} range")
    lo, hi = window
    kernels = [(max(a, lo), min(b, hi), n) for a, b, n in kernels if b > lo and a < hi]
    if not kernels:
        raise TraceMissed("the trace holds no device kernel in the window")
    by_class: Dict[str, float] = defaultdict(float)
    count: Dict[str, int] = defaultdict(int)
    by_name: Dict[str, float] = defaultdict(float)
    for a, b, n in kernels:
        c = classify(n)
        by_class[c] += (b - a) / 1e6
        count[c] += 1
        by_name[n] += (b - a) / 1e6
    short = {c: (count[c], need) for c, need in expect.items() if count[c] < need}
    if short:
        raise TraceMissed("the trace missed launches: "
                          + ", ".join(f"{c} {got} of {need}" for c, (got, need)
                                      in short.items()))
    busy, gaps = _union([(a, b) for a, b, _ in kernels])
    first = min(a for a, _, _ in kernels)
    last = max(b for _, b, _ in kernels)
    gaps = [(lo, first)] + gaps + [(last, hi)]
    labelled = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        inside = [(hb - ha, n) for ha, hb, n in host if ha <= a < hb]
        label = min(inside)[1] if inside else "no host range"
        labelled.append([label, (b - a) / 1e6])
    return {"window_s": (hi - lo) / 1e6, "busy_s": busy / 1e6,
            "by_class": dict(by_class), "count": dict(count),
            "by_name": dict(by_name), "idle_gaps": labelled}


def breakdown(summary: Dict) -> Dict:
    """The result line's ``breakdown``: the kernels that took most time
    (``class: name``), with the unclassified kernels' total a row of its
    own, and the longest idle gaps."""
    ops = sorted(((f"{classify(n)}: {n[:120]}", s) for n, s in
                  summary["by_name"].items()), key=lambda r: -r[1])
    rows = [list(r) for r in ops[:10]]
    other = summary["by_class"].get("unclassified", 0.0)
    if other:
        rows = rows[:9] + [["unclassified kernels (all)", other]]
    return {"device_ops": rows, "idle_gaps": summary["idle_gaps"]}
