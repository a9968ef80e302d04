"""Spans and counters of the port: where a step's host time goes, what it
launches on the card and what it reads back.

Spans.  ``with span(name):`` marks a layer boundary.  A span is off, and
costs one check, unless ``torch.profiler`` is recording or the caller is
inside :func:`recording`.  On, it records ``(name, t0_ns, t1_ns, parent,
step)`` on ``time.time_ns()`` in memory and, while the profiler records,
opens ``record_function(name)`` too, so that the span lands in the chrome
trace as a ``user_annotation`` on the kernels' clock.  Each ``sqp.solve``
span opens a new step id, which the spans after it share.  A span that
opens on after the previous one ran off starts a new stretch: ``spans()``
is the newest stretch, so each traced run is read alone.  The name's
prefix before the first dot is its layer (``LAYERS``).

Counters.  ``count(table, name)`` adds one to a module's table: the kernel
launches (``LAUNCHES`` of ``ops/gp_sample.py``, ``ops/gp_hall.py``,
``ops/ipm.py``, ``ops/glue.py``, ``ops/batch_linalg.py``,
``ops/batched_chol.py``; ``ipm``'s by kernel and build), the QP routes
(``ocp/qp.py`` ``ROUTES``), and here
``SYNCS``, by call site: each point on the MPC step's path where the host
waits for the card, a read of a tensor's value or a copy from pageable host
memory (a scalar or an index list), as torch's sync-debug mode finds them
on the card (``tests/test_torch_kernels_cuda.py``).  The same sites count
on the CPU, so a CPU test sees what the card would.  ``HALL_ROWS``, by
fill: one for each hall-conditioned GP stage (SQP iterations >= 1, either
route), under the number of buffer rows it conditions on (``hall_n *
Ty``).
"""

from __future__ import annotations

import contextlib
import heapq
import json
import threading
import time
from collections import Counter, defaultdict
from typing import NamedTuple

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled

STEP_SPAN = "sqp.solve"
# span-name prefix -> the layer as BENCHMARK.json and PERF.md name it
GP = "GP stage (agent.py, gp/, ops/gp_sample.py, ops/gp_hall.py)"
GLUE = ("Glue (agent.dyn_linearization, ocp/condense.py, ocp/assemble.py, "
        "the SQP driver's torch ops)")
QP = "QP (ocp/qp.py, ops/ipm.py)"
LOOP = "Closed loop (the harness's episodes over sqp.solve)"
LAYERS = {"gp": GP, "glue": GLUE, "sqp": GLUE, "qp": QP, "loop": LOOP}
OUTSIDE = "outside spans"

# the host's waits for the card, by call site
SYNCS: Counter = Counter()
# the hall-conditioned GP stages, by the buffer rows each conditions on
HALL_ROWS: Counter = Counter()

_COUNT_LOCK = threading.Lock()
_TALLY = threading.local()


class Span(NamedTuple):
    name: str
    t0_ns: int
    t1_ns: int          # None while the span is open
    parent: int         # index of the enclosing span in its stretch, or -1
    step: int           # 0 before the stretch's first sqp.solve


class _State:
    """The newest stretch: its spans, the step id, the SYNCS and HALL_ROWS
    it started from; whether the last span ran on; the depth of
    ``recording``."""
    def __init__(self):
        self.on = False
        self.depth = 0
        self.spans = []
        self.step = 0
        self.syncs0 = Counter()
        self.hall0 = Counter()


_STATE = _State()
_LOCAL = threading.local()          # each thread's stack of open spans


class _Off:
    """What ``span`` returns while spans are off: one shared no-op."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "prof", "rec", "stack", "rf")

    def __init__(self, name: str, prof: bool):
        self.name, self.prof = name, prof

    def __enter__(self):
        st = _STATE
        if not st.on:                       # a new stretch
            st.on, st.spans, st.step = True, [], 0
            st.syncs0 = Counter(SYNCS)
            st.hall0 = Counter(HALL_ROWS)
            _LOCAL.stack = []
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        if self.name == STEP_SPAN:
            st.step += 1
        self.rec = [self.name, 0, None, stack[-1] if stack else -1, st.step]
        self.stack = stack
        stack.append(len(st.spans))
        st.spans.append(self.rec)
        self.rf = None
        if self.prof:
            self.rf = torch.profiler.record_function(self.name)
        self.rec[1] = time.time_ns()
        if self.rf is not None:
            self.rf.__enter__()
        return None

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.rec[2] = time.time_ns()
        self.stack.pop()
        return False


def span(name: str):
    """A context manager that marks ``name``'s host time (module
    docstring); the shared no-op while the profiler is off and no
    ``recording`` block is open."""
    prof = _profiler_enabled()
    if not prof and not _STATE.depth:
        _STATE.on = False
        return _OFF
    return _On(name, prof)


@contextlib.contextmanager
def recording():
    """Spans on within the block without the profiler: in memory only."""
    _STATE.depth += 1
    try:
        yield
    finally:
        _STATE.depth -= 1


def spans() -> list:
    """The newest stretch's spans (``Span``), in the order they opened."""
    return [Span(*r) for r in _STATE.spans]


def _since(table: Counter, start: Counter) -> Counter:
    d = Counter(table)
    d.subtract(start)
    return +d


def syncs() -> Counter:
    """``SYNCS`` counted since the newest stretch began."""
    return _since(SYNCS, _STATE.syncs0)


def hall_rows() -> Counter:
    """``HALL_ROWS`` counted since the newest stretch began: the hall
    stages by fill."""
    return _since(HALL_ROWS, _STATE.hall0)


def layer(name: str) -> str:
    return LAYERS.get(name.split(".", 1)[0], OUTSIDE)


def _self_ns(records):
    """Each span's length and its self time (its length less its closed
    children's), None for an open span."""
    dur = [(s.t1_ns - s.t0_ns) if s.t1_ns is not None else None
           for s in records]
    self_ns = list(dur)
    for s, d in zip(records, dur):
        if d is not None and s.parent >= 0 and self_ns[s.parent] is not None:
            self_ns[s.parent] -= d
    return dur, self_ns


def host_ms_in(records, prefix: str):
    """Host ms during which a span whose name starts with ``prefix`` is
    the innermost open one (the spans' self time), or None where no closed
    span has that prefix.  Assumes the spans come from one thread."""
    own = [v for s, v in zip(records, _self_ns(records)[1])
           if v is not None and s.name.startswith(prefix)]
    return sum(own) / 1e6 if own else None


def host_ms_by_layer(records) -> dict:
    """Host ms by layer for each step id: every instant belongs to the
    innermost span open then (a span's self time), and ``OUTSIDE`` holds
    the rest of the step.  A step runs from its ``sqp.solve``'s start to
    the next one's, the last to its last span's end; spans before the
    first solve form step 0.  Open spans are left out.  Assumes the spans
    come from one thread."""
    dur, self_ns = _self_ns(records)
    out = defaultdict(lambda: defaultdict(float))
    first, last = {}, {}
    for i, s in enumerate(records):
        if dur[i] is None:
            continue
        out[s.step][layer(s.name)] += self_ns[i] / 1e6
        first.setdefault(s.step, s.t0_ns)
        last[s.step] = max(last.get(s.step, s.t1_ns), s.t1_ns)
    steps = sorted(out)
    for k, nxt in zip(steps, steps[1:] + [None]):
        end = first[nxt] if nxt is not None else last[k]
        covered = sum(v for n, v in out[k].items() if n != OUTSIDE)
        out[k][OUTSIDE] = (end - first[k]) / 1e6 - covered
    return {k: dict(v) for k, v in out.items()}


def write(path: str, base_ns: int = 0) -> None:
    """The newest stretch as chrome-trace ``X`` events, ``ts`` in
    microseconds after ``base_ns`` (a profiler export's
    ``baseTimeNanoseconds``, to line the spans up with its events)."""
    ev = [{"name": s.name, "cat": "obs_span", "ph": "X", "pid": 0, "tid": 0,
           "ts": (s.t0_ns - base_ns) / 1e3, "dur": (s.t1_ns - s.t0_ns) / 1e3,
           "args": {"step": s.step, "parent": s.parent, "layer":
                    layer(s.name)}}
          for s in spans() if s.t1_ns is not None]
    with open(path, "w") as f:
        json.dump({"traceEvents": ev, "baseTimeNanoseconds": base_ns}, f)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


def _innermost(intervals, mids) -> list:
    """For each of the sorted ``mids``, the label of the latest-starting
    (start, end, label) interval that holds it, or None."""
    intervals = sorted(intervals)
    heap, i, out = [], 0, []
    for m in mids:
        while i < len(intervals) and intervals[i][0] <= m:
            s, e, lab = intervals[i]
            heapq.heappush(heap, (-s, e, lab))
            i += 1
        while heap and heap[0][1] < m:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def idle_by_span(events) -> dict:
    """Device idle us by the innermost program span open at each gap's
    midpoint, from chrome-trace events (``ts``, ``dur`` in us): the
    kernels, copies and fills, the ``user_annotation`` spans and the host
    ops, from the first program span's start to the last one's end.  A gap
    with no program span open goes to the innermost host op, and with none
    to ``OUTSIDE``."""
    def iv(e):
        return float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]
    prog = [iv(e) for e in events if e.get("cat") == "user_annotation"
            and e["name"].split(".", 1)[0] in LAYERS]
    if not prog:
        return {}
    w0, w1 = min(p[0] for p in prog), max(p[1] for p in prog)
    dev = sorted((max(a, w0), min(b, w1)) for a, b, _ in
                 (iv(e) for e in events if e.get("cat") in DEVICE_CATS))
    gaps, t = [], w0
    for a, b in dev:
        if b <= a:
            continue
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    gaps.sort(key=lambda g: g[0] + g[1])
    mids = [(a + b) / 2 for a, b in gaps]
    by_span = _innermost(prog, mids)
    by_host = _innermost([iv(e) for e in events
                          if e.get("cat") in HOST_CATS], mids)
    idle = defaultdict(float)
    for (a, b), s, h in zip(gaps, by_span, by_host):
        idle[s or h or OUTSIDE] += b - a
    return dict(idle)


def count(table: dict, name: str, tally: bool = True, n: int = 1) -> None:
    """``n`` events ``name`` (a kernel launch, a QP route, a host read):
    added to ``table`` under a lock (the blocked solve launches from one
    thread per block) and, with ``tally``, to the calling thread's
    :func:`thread_tally`, a (kernel, build) launch under its kernel."""
    with _COUNT_LOCK:
        table[name] += n
    mine = getattr(_TALLY, "counts", None)
    if tally and mine is not None:
        key = name[0] if isinstance(name, tuple) else name
        mine[key] = mine.get(key, 0) + n


@contextlib.contextmanager
def thread_tally():
    """The counts :func:`count` records from this thread meanwhile, as a
    dict filled in place."""
    _TALLY.counts = {}
    try:
        yield _TALLY.counts
    finally:
        _TALLY.counts = None
