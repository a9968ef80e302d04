"""Cross-shard reductions over the sample axis, plain and order-defined.

Counterpart of ``sampling_gpmpc_tpu/parallel/collectives.py``.  A group is
either a ``torch.distributed`` ``ProcessGroup`` (one process per shard) or
an in-process :class:`BlockGroup` (one Python thread per block, the blocks
taking turns between collectives).  :func:`make_reducers`
returns ``(psum, pmin, pmax)``; with ``group=None`` all three are
identities, so the single-device route runs exactly the ops it runs
without them.

Each reducer takes a tensor or a tuple of tensors.  A tuple is ONE
collective round trip: its leaves are flattened into one buffer, reduced,
and split again; the arithmetic on each leaf is what a call per leaf would
do.

``ordered=True`` is the determinism mode.  The sum of a ProcessGroup's
native all-reduce is an implementation detail of the backend (ring or
tree, chunking), and the sampled-GP + QP chain amplifies last-ulp
differences through its discrete branches.  The ordered sum gathers every
rank's partial into a stack in rank order and adds it sequentially,
``acc = g[0]; acc = acc + g[1]; ...``: one well-defined floating-point sum,
whatever the backend, which a :class:`BlockGroup` computes bit for bit in
one process.  min and max are order-independent and stay native.

Backends.  NCCL reduces CUDA tensors on the card.  Gloo's collectives on
CUDA tensors cover less than NCCL's (and several ranks sharing one card is
a gloo layout), so a gloo group stages the flat payload through host
memory explicitly: one copy to the host, the collective there, one copy
back.  That is the design for gloo, chosen by the group's backend, not a
fallback.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List

import torch
import torch.distributed as dist

from sampling_gpmpc_torch import obs


class LockstepError(RuntimeError):
    """A block of a :class:`BlockGroup` waited past the timeout for its
    turn, or another block failed."""


class BlockGroup:
    """n blocks of one program in one process: one thread per block.

    The blocks take turns: one runs at a time, from one collective to the
    next, and hands the turn to the next block when it has put its
    partial into the shared slot list.  When the turn comes back to block
    0 every block has put its partial, and each block reads the list in
    its own next turn.  Two slot lists alternate between consecutive
    collectives, so a list is written again only after every block has
    read it.  Taking turns keeps the blocks off each other's interpreter
    lock: blocks running at once contend for it at every torch op, and on
    the card that cost more than the blocks' overlap gained (PERF.md,
    "the sample-sharded solve").  A block that waits longer than ``timeout``
    for its turn (a block out of lockstep) fails the run instead of
    hanging it.

    On the card every block enqueues on one shared side stream, so a
    block's read of another's partial runs after the kernels that made
    it: the producer enqueued them before handing the turn on.

    Use :meth:`run` to execute ``fn`` once per block; inside it,
    :meth:`rank` is the calling block's index.  ``launches`` holds each
    block's kernel launches of the last :meth:`run`.
    """

    def __init__(self, n: int, timeout: float = 300.0):
        if n < 1:
            raise ValueError(f"BlockGroup needs n >= 1, got {n}")
        self.n = n
        self.timeout = timeout
        self._slots = ([None] * n, [None] * n)
        self._cond = threading.Condition()
        self._turn = 0
        self._failed = False
        self._local = threading.local()
        self.launches: List[dict] = [{} for _ in range(n)]

    def size(self) -> int:
        return self.n

    def rank(self) -> int:
        r = getattr(self._local, "rank", None)
        if r is None:
            raise RuntimeError("BlockGroup.rank() outside BlockGroup.run")
        return r

    def all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every block's ``x``, in block order."""
        local = self._local
        slots = self._slots[local.parity]
        local.parity ^= 1
        slots[local.rank] = x
        self._pass_turn(local.rank)
        self._await_turn(local.rank)
        return list(slots)

    def _pass_turn(self, r: int):
        with self._cond:
            self._turn = (r + 1) % self.n
            self._cond.notify_all()

    def _await_turn(self, r: int):
        with self._cond:
            if not self._cond.wait_for(
                    lambda: self._turn == r or self._failed, self.timeout):
                self._failed = True
                self._cond.notify_all()
                raise LockstepError(
                    f"BlockGroup: block {r} waited {self.timeout} s for its "
                    f"turn (a block left lockstep)")
            if self._failed:
                raise LockstepError(f"BlockGroup: block {r} stopped: "
                                    f"another block failed")

    def run(self, fn: Callable, *args, **kwargs) -> list:
        """``fn(*args, **kwargs)`` once per block, taking turns; returns
        the blocks' results in block order.  A failing block stops the
        others at their next turn, and its exception is raised here."""
        self._slots = ([None] * self.n, [None] * self.n)
        self._turn, self._failed = 0, False
        results: list = [None] * self.n
        errors: list = [None] * self.n
        stream = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()  # inputs made on the caller's stream
            stream = torch.cuda.Stream()

        def block(r):
            self._local.rank, self._local.parity = r, 0
            try:
                self._await_turn(r)
                with obs.thread_tally() as tally:
                    if stream is None:
                        results[r] = fn(*args, **kwargs)
                    else:
                        with torch.cuda.stream(stream):
                            results[r] = fn(*args, **kwargs)
                self.launches[r] = dict(tally)
                self._pass_turn(r)
            except BaseException as e:      # noqa: BLE001 - re-raised below
                errors[r] = e
                with self._cond:
                    self._failed = True
                    self._cond.notify_all()
            finally:
                self._local.rank = None

        threads = [threading.Thread(target=block, args=(r,), daemon=True)
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if stream is not None:
            stream.synchronize()
        # the block that failed first, not the ones it stopped
        failed = [e for e in errors if e is not None]
        cause = [e for e in failed if not isinstance(e, LockstepError)]
        if failed:
            raise (cause or failed)[0]
        return results


def group_size(group) -> int:
    if group is None:
        return 1
    if isinstance(group, BlockGroup):
        return group.size()
    return dist.get_world_size(group)


def group_rank(group) -> int:
    if group is None:
        return 0
    if isinstance(group, BlockGroup):
        return group.rank()
    return dist.get_rank(group)


def _staged(group, x: torch.Tensor) -> bool:
    """Whether a process group's collective runs on a host copy of x."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``x`` (same shape and dtype on every rank), in rank
    order; ``[x]`` without a group."""
    if group is None:
        return [x]
    if isinstance(group, BlockGroup):
        return group.all_gather(x)
    src = x.contiguous()
    if _staged(group, src):
        src = src.cpu()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return [t.to(x.device) for t in out]


def ordered_sum(parts: List[torch.Tensor]) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` left to right: the one sum both group
    kinds compute."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _native(x: torch.Tensor, group, op) -> torch.Tensor:
    """A process group's all-reduce of a flat buffer (host-staged on
    gloo)."""
    buf = x.cpu() if _staged(group, x) else x     # x: a fresh flat buffer
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(x.device)


def _reduce_flat(flat: torch.Tensor, group, kind: str,
                 ordered: bool) -> torch.Tensor:
    if isinstance(group, BlockGroup) or (kind == "sum" and ordered):
        parts = all_gather(flat, group)
        if kind == "sum":
            return ordered_sum(parts)
        stack = torch.stack(parts)
        return stack.amin(0) if kind == "min" else stack.amax(0)
    op = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
          "max": dist.ReduceOp.MAX}[kind]
    return _native(flat, group, op)


class TrafficCounter:
    """Rounds and payload bytes of the reducers' collectives.

    Each round is recorded under (rank, reducer kind, scope): ``kind`` is
    "sum", "min" or "max"; ``scope`` is the label the reducers were made
    with (:func:`make_reducers`): "sqp" by default (the SQP iteration's
    body: the condensed cost, the convergence norms, the GP stage's
    offsets), "qp prepare" and "mehrotra" where ``ops/ipm.py`` makes its
    own.  The payload is this rank's flat buffer (what the JAX package's
    HLO operand holds), whatever the group kind does with it.
    Thread-safe: the blocks of a :class:`BlockGroup` record from their own
    threads.
    """

    def __init__(self):
        self.records: dict = {}
        self._lock = threading.Lock()

    def record(self, group, kind: str, scope: str, nbytes: int) -> None:
        key = (group_rank(group), kind, scope)
        with self._lock:
            n, b = self.records.get(key, (0, 0))
            self.records[key] = (n + 1, b + nbytes)

    def table(self, rank: int = 0) -> dict:
        """{(kind, scope): (rounds, bytes)} of one rank."""
        return {k[1:]: v for k, v in sorted(self.records.items())
                if k[0] == rank}


_COUNTING: List[TrafficCounter] = []


@contextlib.contextmanager
def counting(counter: TrafficCounter):
    """Give ``counter`` to the reducers that :func:`make_reducers` makes
    meanwhile (in every thread)."""
    _COUNTING.append(counter)
    try:
        yield counter
    finally:
        _COUNTING.remove(counter)


def _reducer(group, kind: str, ordered: bool, scope: str, counter):
    def reduce(x):
        leaves = tuple(x) if isinstance(x, tuple) else (x,)
        flat = torch.cat([t.reshape(-1) for t in leaves])
        if counter is not None:
            counter.record(group, kind, scope,
                           flat.numel() * flat.element_size())
        red = _reduce_flat(flat, group, kind, ordered)
        out, i = [], 0
        for t in leaves:
            out.append(red[i:i + t.numel()].reshape(t.shape))
            i += t.numel()
        return tuple(out) if isinstance(x, tuple) else out[0]
    return reduce


def make_reducers(group, ordered: bool = False, scope: str = "sqp"):
    """``(psum, pmin, pmax)`` for a maybe-sharded computation.

    ``group=None`` (single device): identities.  Otherwise collectives over
    ``group``: with ``ordered`` the sum is the gathered rank-order
    sequential sum (module docstring); a :class:`BlockGroup` always sums
    that way, being one program.  Each reducer takes a tensor or a tuple of
    tensors of one dtype (one round trip for the tuple).  Under
    :func:`counting` the reducers record each round under ``scope``;
    otherwise they run the collectives alone.
    """
    if group is None:
        ident = lambda x: x  # noqa: E731
        return ident, ident, ident
    counter = _COUNTING[-1] if _COUNTING else None
    return tuple(_reducer(group, kind, ordered, scope, counter)
                 for kind in ("sum", "min", "max"))


def sample_offset(group, ns_local: int) -> int:
    """Global index of this rank's first sample."""
    return group_rank(group) * ns_local


def split(a: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of a global array along ``dim`` (equal blocks)."""
    n = group_size(group)
    if a.shape[dim] % n:
        raise ValueError(f"axis {dim} of size {a.shape[dim]} does not "
                         f"divide over {n} ranks")
    return a.chunk(n, dim=dim)[group_rank(group)].contiguous()


def gather_cat(a: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The global array from every rank's block along ``dim``."""
    return torch.cat(all_gather(a.contiguous(), group), dim=dim)

