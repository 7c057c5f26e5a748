"""Structural analyzer of one rank's op trace — the port's counterpart of
``repro.perf.hlo_analysis``.

The reference reads the post-SPMD HLO that XLA compiles for one device.
The port runs eager PyTorch, which has no HLO: what one rank executes is
the sequence of ops its dispatcher sees.  ``OpRecorder`` is a
``TorchDispatchMode`` that watches that sequence while a step runs —
under ``FakeTensorMode`` for a dry run (nothing allocated, nothing
launched), or on real tensors to hold a dry run against a real step — and
accumulates, per rank:

  * dot FLOPs        2 * prod(result dims) * prod(contracting dims) of
                     every ``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``,
                     ``dot`` (and ``matmul`` / ``einsum`` where they reach
                     the dispatcher undecomposed)
  * dot bytes        lhs + rhs + result bytes of those ops (a bias is not
                     an operand of the dot, as in the reference's HLO)
  * collective bytes per kind: the result buffer's bytes (the largest
                     one of a coalesced call; of an all-to-all, its
                     largest per-peer piece, as XLA's tuple all-to-all
                     gives it), all-reduce counted 2x for the ring, and
                     ``bytes_bf16adj`` counting f32 buffers at half width
                     (the reference's rules, ``hlo_analysis.py:233-245``)
  * kernel FLOPs     the port's hand-written kernels by a rule of their
                     own: K4 (``repro_torch::local_attn``) does
                     4 * BH * kept pairs * D, the kept pairs being the
                     causal sliding-window (query, key) pairs.  The
                     reference's HLO has no dot for it, so it is kept out
                     of ``dot_flops``
  * memory           the bytes of the storages alive while the step runs
                     (each tracked by a weak reference from the op that
                     made it): the arguments', the outputs', and the peak

Python loops (layer groups, the attention's chunk pairs, micro-batches,
the recompute of checkpointed groups) run unrolled, so every op is seen as
often as it runs: the counts are exact by construction, and the
reference's while-loop trip counts (``_while_trip_count``,
``_multipliers``) have no counterpart.  ``whiles`` is an empty list and
``n_computations`` the number of recorded ops.

Ops on DTensors are passed to DTensor (the recorder declines them), so the
recorder sees the rank's local ops and the collectives DTensor issues;
``prim`` ops (a fake tensor's device query) are metadata reads, not
counted.  The c10d ops map onto the reference's five kinds: ``allreduce_``
-> all-reduce, ``_allgather_base_`` / ``allgather_into_tensor_coalesced_``
-> all-gather, ``_reduce_scatter_base_`` -> reduce-scatter,
``alltoall_base_`` -> all-to-all, a ``recv_`` (the receiving half of a
send/recv pair) -> collective-permute, and the ``_c10d_functional`` forms
that DTensor uses the same way; ``wait_tensor`` is never counted.  A
``broadcast_`` (the MoE's drop-fraction telemetry) has no reference
kind: it is counted under ``broadcast``.
"""
from __future__ import annotations

import math
import weakref
from collections import Counter
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")
# kinds counted beyond the reference's five
EXTRA_COLLECTIVES = ("broadcast",)

# op -> (kind, where its result buffer is: "arg0" (an in-place c10d op's
# first argument) or "out"; "split": an all-to-all, its largest piece)
_COLLECTIVE_TABLE = {
    "c10d.allreduce_": ("all-reduce", "arg0"),
    "c10d.allreduce_coalesced_": ("all-reduce", "arg0"),
    "c10d._allgather_base_": ("all-gather", "arg0"),
    "c10d.allgather_": ("all-gather", "arg0"),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", "arg0"),
    "c10d._reduce_scatter_base_": ("reduce-scatter", "arg0"),
    "c10d.reduce_scatter_": ("reduce-scatter", "arg0"),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", "arg0"),
    "c10d.alltoall_base_": ("all-to-all", "split"),
    "c10d.recv_": ("collective-permute", "arg0"),
    "c10d.broadcast_": ("broadcast", "arg0"),
}
for _ns in ("_c10d_functional", "_c10d_functional_autograd"):
    _COLLECTIVE_TABLE.update({
        f"{_ns}.all_reduce": ("all-reduce", "out"),
        f"{_ns}.all_reduce_": ("all-reduce", "out"),
        f"{_ns}.all_reduce_coalesced": ("all-reduce", "out"),
        f"{_ns}.all_gather_into_tensor": ("all-gather", "out"),
        f"{_ns}.all_gather_into_tensor_out": ("all-gather", "out"),
        f"{_ns}.all_gather_into_tensor_coalesced": ("all-gather", "out"),
        f"{_ns}.reduce_scatter_tensor": ("reduce-scatter", "out"),
        f"{_ns}.reduce_scatter_tensor_coalesced": ("reduce-scatter", "out"),
        f"{_ns}.all_to_all_single": ("all-to-all", "split"),
        f"{_ns}.broadcast": ("broadcast", "out"),
        f"{_ns}.broadcast_": ("broadcast", "out"),
    })

# K4's op (kernels/ops.py): q, k, v (BH, S, D), window, softcap
LOCAL_ATTN_OP = "repro_torch.local_attn"


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _buffer_bytes(x) -> int:
    """A tensor's bytes; of a list, its largest entry (a nested list is one
    buffer in pieces: their sum)."""
    if isinstance(x, torch.Tensor):
        return _nbytes(x)
    if isinstance(x, (list, tuple)):
        vals = [sum(_nbytes(t) for t in e) if isinstance(e, (list, tuple))
                else _buffer_bytes(e) for e in x]
        return max(vals, default=0)
    return 0


def _buffer_dtype(x):
    if isinstance(x, torch.Tensor):
        return x.dtype
    for t in tree_leaves(x):
        if isinstance(t, torch.Tensor):
            return t.dtype
    return None


def _group_size(pg) -> int:
    """The size of a c10d op's process group (a boxed ``ProcessGroup``)."""
    from torch.distributed.distributed_c10d import ProcessGroup
    return ProcessGroup.unbox(pg).size()


def _largest_piece(name, args, out) -> int:
    """An all-to-all's largest per-peer piece of its output."""
    if name.startswith("c10d."):
        buf, splits = args[0], list(args[3]) if len(args) > 3 else []
        n = len(splits) or _group_size(args[2])
    else:
        buf, splits = out, list(args[1])
        n = len(splits)
    rows = buf.shape[0] if buf.dim() else 1
    row_bytes = _nbytes(buf) // max(rows, 1)
    if splits:
        return max(splits) * row_bytes
    return -(-rows // max(n, 1)) * row_bytes


def kept_pairs(s: int, window: int) -> int:
    """(query, key) pairs a causal sliding window keeps in a sequence of
    ``s``: sum over query q of min(q + 1, window)."""
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def local_attn_flops(bh: int, s: int, d: int, window: int) -> int:
    """K4's work: QK^T and PV over the kept pairs, 2 FLOPs a multiply-add
    each, 4 * BH * kept pairs * D."""
    return 4 * bh * kept_pairs(s, window) * d


def _dot(name, args):
    """(FLOPs, operand bytes) of a dot op, or None for another op."""
    if name in ("aten.mm", "aten.bmm", "aten.mv", "aten.dot"):
        a, b = args[0], args[1]
    elif name in ("aten.addmm", "aten.baddbmm"):
        a, b = args[1], args[2]
    elif name == "aten.matmul":
        a, b = args[0], args[1]
    elif name == "aten.einsum":
        return _einsum(args[0], args[1])
    else:
        return None
    k = a.shape[-1]
    if name == "aten.matmul":
        res = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]) + \
            (a.shape[-2] if a.dim() > 1 else 1,
             b.shape[-1] if b.dim() > 1 else 1)
    elif name in ("aten.mv", "aten.dot"):
        res = (a.shape[0],) if name == "aten.mv" else ()
    else:
        res = tuple(a.shape[:-1]) + (b.shape[-1],)
    n_res = math.prod(res)
    res_bytes = n_res * a.element_size()
    return 2.0 * n_res * k, float(_nbytes(a) + _nbytes(b) + res_bytes)


def _einsum(eq: str, operands):
    """(FLOPs, bytes) of a two-operand einsum: 2 * prod(output dims) *
    prod(summed dims)."""
    if len(operands) != 2 or "->" not in eq:
        return None
    ins, out = eq.replace(" ", "").split("->")
    dims = {}
    for spec, t in zip(ins.split(","), operands):
        for c, n in zip(spec, t.shape):
            dims[c] = n
    n_out = math.prod(dims[c] for c in out)
    n_sum = math.prod(n for c, n in dims.items() if c not in out)
    a, b = operands
    return 2.0 * n_out * n_sum, float(
        _nbytes(a) + _nbytes(b) + n_out * a.element_size())


class OpRecorder(TorchDispatchMode):
    """Watches the ops one rank dispatches and accumulates what
    ``analyze`` reports.  Use it around one step::

        rec = OpRecorder()
        rec.watch_arguments(args)
        with rec:
            out = step(*args)
        rec.watch_outputs(out)
        analyze(rec)

    Under ``FakeTensorMode`` enter the fake mode first (the recorder then
    sees every op before the fake mode runs it)."""

    def __init__(self):
        super().__init__()
        self.ops: Counter = Counter()
        # torch.utils.flop_counter's count of the local ops (what
        # FlopCounterMode reports), the counterpart of cost_analysis
        self.flops = 0.0
        self.dot_flops = 0.0
        self.dot_bytes = 0.0
        self.kernel_flops = 0.0
        self.collectives = {k: {"bytes": 0.0, "count": 0.0,
                                "bytes_bf16adj": 0.0}
                            for k in COLLECTIVE_OPS + EXTRA_COLLECTIVES}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.argument_bytes = 0
        self.output_bytes = 0
        self._live: Dict[int, int] = {}
        self._paused = 0
        self._unpatch = None

    # -- memory ---------------------------------------------------------------

    def _release(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, t) -> Optional[int]:
        """Count ``t``'s storage as live until it is freed; its key."""
        if not isinstance(t, torch.Tensor) or t.layout != torch.strided:
            return None
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._live:
            self._live[key] = st.nbytes()
            self.live_bytes += st.nbytes()
            weakref.finalize(st, self._release, key)
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return key

    def _storages(self, tree) -> Dict[int, int]:
        out = {}
        for t in tree_leaves(tree):
            if hasattr(t, "to_local") and hasattr(t, "placements"):
                t = t.to_local()
            key = self._track(t)
            if key is not None:
                out[key] = self._live[key]
        return out

    def watch_arguments(self, args) -> int:
        """Track the step's arguments (a DTensor by its local tensor); adds
        and returns their bytes, each storage once."""
        n = sum(self._storages(args).values())
        self.argument_bytes += n
        return n

    def watch_outputs(self, out) -> int:
        """The bytes of the step's outputs, each storage once (an output
        that is an updated argument counts, as XLA counts an aliased
        output)."""
        self.output_bytes = sum(self._storages(out).values())
        return self.output_bytes

    # -- dispatch -------------------------------------------------------------

    def __enter__(self):
        self._unpatch = _pause_during_meta_propagation(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self._unpatch is not None:
                self._unpatch()
                self._unpatch = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        if func.namespace == "prim":
            return out
        self.ops[str(func)] += 1
        name = f"{func.namespace}.{func._opname}"
        try:
            self._account(func, name, args, kwargs, out)
        finally:
            for t in tree_leaves(out):
                self._track(t)
        return out

    def _account(self, func, name, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        dot = _dot(name, args)
        if dot is not None:
            self.dot_flops += dot[0]
            self.dot_bytes += dot[1]
            return
        if name == LOCAL_ATTN_OP:
            q, window = args[0], args[3]
            bh, s, d = q.shape
            self.kernel_flops += local_attn_flops(bh, s, d, int(window))
            return
        entry = _COLLECTIVE_TABLE.get(name)
        if entry is None:
            return
        kind, where = entry
        buf = args[0] if where == "arg0" or (
            where == "split" and name.startswith("c10d.")) else out
        b = _largest_piece(name, args, out) if where == "split" \
            else _buffer_bytes(buf)
        factor = 2.0 if kind == "all-reduce" else 1.0
        adj = 0.5 if _buffer_dtype(buf) == torch.float32 else 1.0
        c = self.collectives[kind]
        c["bytes"] += b * factor
        c["count"] += 1
        c["bytes_bf16adj"] += b * factor * adj


def _pause_during_meta_propagation(rec: OpRecorder):
    """DTensor derives an op's output shape by running the op once on fake
    tensors of the global shapes (``ShardingPropagator.
    _propagate_tensor_meta_non_cached``, on a cache miss); those shadow
    ops are not the rank's work, so the recorder ignores them.  Returns
    the function that undoes the patch (None where torch has no such
    method)."""
    try:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
    except ImportError:
        return None
    name = "_propagate_tensor_meta_non_cached"
    orig = ShardingPropagator.__dict__.get(name)
    if orig is None:
        return None

    def paused(self, *a, **kw):
        rec._paused += 1
        try:
            return orig(self, *a, **kw)
        finally:
            rec._paused -= 1

    setattr(ShardingPropagator, name, paused)
    return lambda: setattr(ShardingPropagator, name, orig)


def memory_analysis(rec: OpRecorder) -> dict:
    """The reference's ``memory_analysis`` keys read from a recorded step:
    the arguments' bytes, the outputs' bytes, and the peak of live bytes
    less the arguments.  ``generated_code_size_in_bytes`` has no
    counterpart (eager PyTorch generates no program) and is left out."""
    return {"argument_size_in_bytes": int(rec.argument_bytes),
            "output_size_in_bytes": int(rec.output_bytes),
            "temp_size_in_bytes": int(rec.peak_bytes - rec.argument_bytes)}


def analyze(rec: OpRecorder) -> dict:
    """The reference's ``analyze`` result keys from a recorded step: dot
    FLOPs and bytes, collectives per kind, their totals, ``whiles`` (empty:
    loops run unrolled) and ``n_computations`` (the recorded ops); plus
    ``kernel_flops``, the hand-written kernels' work."""
    coll = {k: dict(v) for k, v in rec.collectives.items()}
    return {
        "dot_flops": rec.dot_flops,
        "dot_bytes": rec.dot_bytes,
        "collectives": coll,
        "collective_bytes": sum(v["bytes"] for v in coll.values()),
        "collective_bytes_bf16adj": sum(v["bytes_bf16adj"]
                                        for v in coll.values()),
        "whiles": [],
        "n_computations": int(sum(rec.ops.values())),
        "kernel_flops": rec.kernel_flops,
    }
