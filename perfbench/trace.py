"""The traced steps: events from ``torch.profiler`` and their reduction.

Events are chrome-trace dicts (``name``, ``cat``, ``ts`` and ``dur`` in
microseconds) from the profiler's chrome trace export, so the readers
are tested on canned traces.
Device work is every ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` event;
each traced step is one ``perfbench_step`` annotation on the host.
"""

from __future__ import annotations

import dataclasses
import heapq
import json
import os
import re
import tempfile
from collections import defaultdict

STEP = "perfbench_step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
NO_HOST_OP = "python (no traced host op)"


def base_name(name: str) -> str:
    """A device op's name without its return type, namespaces, template
    arguments and parameters: ``void (anonymous namespace)::
    gp_sample_kernel<true>(float const*, ...)`` -> ``gp_sample_kernel``;
    copies and fills keep their own names."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split(" (")[0]
    s = name.replace("(anonymous namespace)::", "")
    s = re.sub(r"^void\s+", "", s)
    depth, cut = 0, len(s)
    for i, ch in enumerate(s):
        if ch in "<(" and depth == 0:
            cut = i
            break
    return s[:cut].split("::")[-1].strip() or name


def events_from_profiler(prof) -> list:
    """The profiler's complete events as chrome-trace dicts, through its
    chrome trace export to a file in the temporary directory, removed
    after reading."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return [e for e in json.load(f)["traceEvents"]
                    if e.get("ph") == "X" and "dur" in e]
    finally:
        os.remove(path)


def _union(spans):
    total, end, merged = 0.0, float("-inf"), []
    for s, e in sorted(spans):
        if e <= end:
            continue
        s = max(s, end)
        if merged and s <= merged[-1][1]:
            merged[-1][1] = e
        else:
            merged.append([s, e])
        total += e - s
        end = e
    return total, merged


@dataclasses.dataclass
class Summary:
    """A traced window reduced: its steps, length and device busy time
    (us), the device ops by base name [us, count], the count of device
    ops, and the idle time (us) by the host op in progress."""
    steps: int
    window_us: float
    busy_us: float
    ops: dict
    n_ops: int
    idle_by_host: dict

    def device_us(self, prefixes) -> float:
        """Device time of the ops whose base names start with one of
        ``prefixes``; None where none matches."""
        hit = [v[0] for k, v in self.ops.items() if k.startswith(prefixes)]
        return sum(hit) if hit else None

    def breakdown(self, top: int = 10) -> dict:
        dev = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v[0] / 1e6] for k, v in dev],
                "idle_gaps": [[k, v / 1e6] for k, v in gaps]}


def reduce(events) -> Summary:
    """Reduce chrome-trace events of the traced steps.  The window runs
    from the first step annotation's start to the last one's end; busy
    time is the union of device intervals inside it; each idle gap is
    labelled by the innermost host op or runtime call in progress at its
    midpoint."""
    steps = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] == STEP]
    if not steps:
        raise ValueError("the trace holds no perfbench_step annotation")
    w0 = min(float(e["ts"]) for e in steps)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in steps)
    spans, ops = [], defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            s, d = float(e["ts"]), float(e["dur"])
            spans.append((max(s, w0), min(s + d, w1)))
            k = ops[base_name(e["name"])]
            k[0] += d
            k[1] += 1
    spans = [(s, e) for s, e in spans if e > s]
    busy, merged = _union(spans)
    edges = [w0] + [x for m in merged for x in m] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in events
                  if e.get("cat") in HOST_CATS)
    idle = defaultdict(float)
    heap, i = [], 0
    for mid, length in sorted(((a + b) / 2, b - a) for a, b in gaps):
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(heap, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        idle[heap[0][2] if heap else NO_HOST_OP] += length
    return Summary(steps=len(steps), window_us=w1 - w0, busy_us=busy,
                   ops={k: tuple(v) for k, v in ops.items()},
                   n_ops=sum(v[1] for v in ops.values()),
                   idle_by_host=dict(idle))
