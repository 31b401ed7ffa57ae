"""Cost analysis of one run of a PyTorch program: FLOPs, bytes, collectives.

Counterpart of ``repro.launch.hlo_analysis``.  A PyTorch program has no
HLO: ``analyze(fn, *args, **kwargs)`` runs ``fn`` once under a
``TorchDispatchMode`` and charges every dispatcher op it sees, on ``meta``
tensors (shapes only, nothing allocated), on the CPU or on the card.  The
semantics are the reference's:

  * FLOPs: the ops ``torch.utils.flop_counter`` has formulas for (mm,
    addmm, bmm, baddbmm: 2*M*N*K; convolution: 2 * out * kernel /
    out_features; attention) are ``matmul_flops``; every other op costs 1
    flop per output element; views and free ops (``_FREE_OPS``: allocation,
    ``detach``, ``arange`` -- the reference's iota) cost nothing.  An op is
    counted once, at the level the mode sees it: a composite such as
    ``einsum`` reaches the mode as the ``bmm`` it decomposes into.  A
    Python loop is charged on every pass (the reference multiplies while
    bodies by their trip count).
  * bytes (``hbm_bytes``): in eager PyTorch every op is a kernel boundary,
    so every op is "top level": operand bytes + output bytes, except that
    a slice reader (``index``, ``index_select``, ``gather``, ...) is
    charged 2x its output and an update writer (``index_put``,
    ``scatter``, ``slice_scatter``, ...) 2x its update.  This is the
    traffic of the eager program; it is larger than the reference's count
    of the same step, because XLA fuses ops and keeps their intermediates
    on chip.  It is not a least amount of traffic either: the card's 50 MB
    L2 serves part of an eager op's re-reads.
  * ``compulsory_bytes``: every tensor argument of ``fn`` read once plus
    every tensor it returns written once (``argument_bytes`` +
    ``output_bytes``).  That is a true least amount of traffic, the one a
    roofline share is taken against.
  * collectives: the c10d ops ``core/distributed.py`` issues, mapped onto
    the reference's five kinds (``C10D_KINDS``), each with its group's
    ranks read from its ``ProcessGroup``, the reference's ring-model wire
    bytes (``_wire_bytes``), and whether the group spans pods
    (``group_span``).  A one-rank group is no collective (``Mesh.group``
    gives None for it, and the distributed code then issues none).
  * the compositor kernels, which ``kernels/rasterize.py`` calls through
    ``ctypes`` (no dispatcher op stands for them): each launch is recorded
    by the kernel's wrapper and charged ``KERNEL_OPS`` operations per
    splat-pixel (T * K * tile_h * tile_w) and its operand and output bytes,
    each read or written once.  The projection pair (``kernels/project.py``)
    likewise: ``PROJECT_OPS`` operations a splat and view.

Everything is per rank: each rank of a distributed program runs ``fn`` on
its own shard.  ``per_op`` attributes the totals to op names (the rows
``launch/profile_cell.py`` prints).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import project as project_kernels
from repro_torch.kernels import rasterize

#: operations per splat-pixel of each compositor kernel, as the plain
#: version writes the algorithm (the notes in csrc/rasterize_fwd.cu and
#: csrc/rasterize_bwd.cu): the work behind the kernels' bounds
KERNEL_OPS = {"rasterize_fwd": 27, "rasterize_bwd": 85}
#: operations a splat and view of each projection kernel: the forward's
#: ~280 of the plain version (transform, Jacobian, the 3x3 covariance and
#: its 2x3 sandwich, the eigenvalue bound, the tests), its gradient twice
PROJECT_OPS = {"project_fwd": 280, "project_bwd": 560}

#: c10d op -> the reference's collective kind
C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    # one rung of the exchange's ring shift: the send carries the operand,
    # the matching receive (``recv_``) its output of the same shape
    "send": "collective-permute",
}
#: c10d ops whose first argument is both operand and output (in place)
_C10D_IN_PLACE = {"allreduce_", "allreduce_coalesced_", "send"}
_PROCESS_GROUP = "__torch__.torch.classes.c10d.ProcessGroup"

#: ops with no flops and no traffic of their own (besides ``is_view`` ops):
#: allocation, aliasing, the host's read of a scalar, and iota
_FREE_OPS = {
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "detach", "alias", "lift_fresh", "_unsafe_view",
    "arange", "_local_scalar_dense", "resize_", "set_", "recv_",
}

#: operand-sparse readers: charged 2x their output (the slice), not the
#: whole operand
_SLICE_READERS = {"index", "index_select", "gather", "take", "embedding",
                  "narrow_copy", "slice_copy", "select_copy"}
#: update writers -> the argument holding the update: charged 2x it
_UPDATE_ARG = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
               "scatter": 3, "scatter_": 3, "scatter_add": 3,
               "scatter_add_": 3, "scatter_reduce": 3, "scatter_reduce_": 3,
               "index_add": 3, "index_add_": 3, "index_copy": 3,
               "index_copy_": 3, "slice_scatter": 1, "select_scatter": 1}


def _wire_bytes(op: str, operand_b: int, output_b: int, group: int) -> int:
    """Ring-model bytes one rank moves (``hlo_analysis._wire_bytes``)."""
    if group <= 1:
        return 0
    if op == "all-gather":
        return max(output_b - operand_b, 0)
    if op == "all-reduce":
        return 2 * operand_b * (group - 1) // max(group, 1)
    return operand_b   # reduce-scatter / all-to-all / collective-permute


def group_span(ranks: Sequence[Sequence[int]],
               pod_size: int) -> Tuple[int, bool]:
    """The groups of one collective, as lists of global ranks -> (group
    size, whether any group holds ranks of two pods), where pod p holds
    ranks p * pod_size .. (p + 1) * pod_size - 1 (``pod_size`` 0: no pods).
    In place of ``hlo_analysis._parse_groups``, which reads the same from
    the ``replica_groups`` of an HLO instruction."""
    size = len(ranks[0])
    spans = bool(pod_size) and any(
        len({int(r) // pod_size for r in g}) > 1 for g in ranks)
    return size, spans


@dataclasses.dataclass
class CollectiveOp:
    op: str
    operand_bytes: int
    wire_bytes: int
    group_size: int
    spans_pod: bool


def tensor_bytes(tree) -> int:
    """Bytes of the distinct tensors in a tree (dicts, lists, tuples,
    NamedTuples), each counted once."""
    seen = {id(t): t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)}
    return sum(t.numel() * t.element_size() for t in seen.values())


def _bytes(x) -> int:
    """Bytes of every tensor in an argument (a tensor or a list of them)."""
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _elems(x) -> int:
    return sum(t.numel() for t in pytree.tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _group_ranks(args) -> List[int]:
    for a in args:
        if isinstance(a, torch.ScriptObject) \
                and a._type().qualified_name() == _PROCESS_GROUP:
            pg = dist.ProcessGroup.unbox(a)
            return dist.get_process_group_ranks(pg)
    raise ValueError("a c10d op without a ProcessGroup argument")


class _CostMode(TorchDispatchMode):
    """Charges every op dispatched while it is active (see the module
    docstring); the totals are the sums of ``per_op``."""

    def __init__(self, pod_size: int):
        super().__init__()
        self.pod_size = pod_size
        self.per_op: Dict[str, dict] = {}
        self.collectives: List[CollectiveOp] = []
        self.matmul_flops = 0.0

    def charge(self, name: str, flops: float, n_bytes: float):
        row = self.per_op.setdefault(name, {"count": 0, "flops": 0.0,
                                            "bytes": 0.0})
        row["count"] += 1
        row["flops"] += flops
        row["bytes"] += n_bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet not in flop_registry:
            # a composite reaches the mode whole where autograd is off
            # (``inference_mode``): charge the ops it decomposes into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        name = func._opname
        if func.namespace == "c10d":
            self._collective(func, name, args)
            return out
        if func.is_view or name in _FREE_OPS:
            return out
        operands = (args, {k: v for k, v in kwargs.items() if k != "out"})
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
            self.matmul_flops += flops
        else:
            flops = float(_elems(out))
        if name in _SLICE_READERS:
            n_bytes = 2 * _bytes(out)
        elif name in _UPDATE_ARG and len(args) > _UPDATE_ARG[name] \
                and isinstance(args[_UPDATE_ARG[name]], torch.Tensor):
            n_bytes = 2 * _bytes(args[_UPDATE_ARG[name]])
        else:
            n_bytes = _bytes(operands) + _bytes(out)
        self.charge(str(packet), flops, n_bytes)
        return out

    def _collective(self, func, name, args):
        kind = C10D_KINDS.get(name)
        if kind is None:        # recv_ (its send's output), barrier, waits
            return
        ranks = _group_ranks(args)
        if len(ranks) <= 1:
            return
        if name in _C10D_IN_PLACE:
            operand_b = output_b = _bytes(args[0])
        else:
            output_b, operand_b = _bytes(args[0]), _bytes(args[1])
        size, spans = group_span([ranks], self.pod_size)
        self.collectives.append(CollectiveOp(
            op=kind, operand_bytes=operand_b, wire_bytes=_wire_bytes(kind, operand_b, output_b, size),
            group_size=size, spans_pod=spans))
        self.charge(str(func.overloadpacket), 0.0, operand_b + output_b)


def kernel_costs(name: str, T: int, K: int, F: int, tile_h: int,
                 tile_w: int) -> Tuple[float, float]:
    """(operations, bytes) of one compositor launch: ``KERNEL_OPS`` per
    splat-pixel, and each operand read and each output written once
    (float32 features (T, K, F) and origins (T, 2); the forward writes
    (T, 4, th, tw), the backward reads it and its cotangent and writes
    (T, K, F))."""
    ops = float(KERNEL_OPS[name]) * T * K * tile_h * tile_w
    feats, origins, planes = 4 * T * K * F, 4 * T * 2, 4 * T * 4 * tile_h \
        * tile_w
    if name == "rasterize_fwd":
        return ops, float(feats + origins + planes)
    return ops, float(feats + origins + 2 * planes + feats)


def project_costs(name: str, V: int, N: int) -> Tuple[float, float]:
    """(operations, bytes) of one projection launch over N splats and V
    views: the forward reads each splat's 45 bytes (means, log-scales,
    quaternion, alpha, active) once and writes 29 a view (mean2d, cov2d,
    depth, radius, valid); the backward reads 40 (means, log-scales,
    quaternion) and 24 of cotangent a view, and writes 40 of gradient."""
    ops = float(PROJECT_OPS[name]) * V * N
    if name == "project_fwd":
        return ops, float(N * 45 + V * N * 29)
    return ops, float(N * 80 + V * N * 24)


def analyze(fn, *args, pod_size: int = 0, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and -> its JSON-friendly cost
    summary: the reference's keys (``flops``, ``hbm_bytes``,
    ``collective_wire_bytes``, ``pod_spanning_bytes``, ``collectives`` per
    kind with count, wire bytes, operand bytes and max group,
    ``n_collective_sites``) and ``matmul_flops``, ``compulsory_bytes``
    (``argument_bytes`` + ``output_bytes``) and ``per_op`` ({op name:
    {count, flops, bytes}}, the compositor kernels under their own names).
    ``pod_size`` is the ranks a pod holds (0: no pod axis)."""
    mode = _CostMode(pod_size)
    launches: list = []
    projections: list = []
    prev = rasterize.RECORDER, project_kernels.RECORDER
    rasterize.RECORDER, project_kernels.RECORDER = launches, projections
    try:
        with mode:
            out = fn(*args, **kwargs)
    finally:
        rasterize.RECORDER, project_kernels.RECORDER = prev
    for name, *shape in launches:
        mode.charge(name, *kernel_costs(name, *shape))
    for name, *shape in projections:
        mode.charge(name, *project_costs(name, *shape))
    kinds: Dict[str, dict] = {}
    for col in mode.collectives:
        d = kinds.setdefault(col.op, {"count": 0, "wire_bytes": 0.0,
                                      "operand_bytes": 0.0, "max_group": 0})
        d["count"] += 1
        d["wire_bytes"] += col.wire_bytes
        d["operand_bytes"] += col.operand_bytes
        d["max_group"] = max(d["max_group"], col.group_size)
    arg_b, out_b = tensor_bytes((args, kwargs)), tensor_bytes(out)
    return {
        "flops": sum(r["flops"] for r in mode.per_op.values()),
        "hbm_bytes": sum(r["bytes"] for r in mode.per_op.values()),
        "collective_wire_bytes": float(sum(c.wire_bytes
                                           for c in mode.collectives)),
        "pod_spanning_bytes": float(sum(c.wire_bytes
                                        for c in mode.collectives
                                        if c.spans_pod)),
        "collectives": kinds,
        "n_collective_sites": len(mode.collectives),
        "matmul_flops": mode.matmul_flops,
        "argument_bytes": arg_b,
        "output_bytes": out_b,
        "compulsory_bytes": arg_b + out_b,
        "per_op": mode.per_op,
    }
