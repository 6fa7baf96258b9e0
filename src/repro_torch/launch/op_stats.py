"""The cost of one traced program: the port's counterpart of
``repro/launch/hlo_stats.py``.

The reference reads XLA's optimized, partitioned HLO.  The port runs eagerly,
so its program is what one call sends to ATen: :class:`OpRecorder`, a
``TorchDispatchMode``, sees every ATen op, every collective and every kernel
launch of a call on tensors with no storage (the meta device), and a cost
model turns that record into the reference's numbers, per rank:

  flops       dot flops by ``torch.utils.flop_counter``'s formulas (mm, bmm,
              addmm, baddbmm, convolution, SDPA; ``dot_flops`` alone), every
              other op 1 flop for each output element (as ``hlo_stats.py``
              counts elementwise ops), views, allocations, copies, gathers
              and collectives none; plus each modeled kernel launch's ``cost``
              operations (``kernel_flops``);
  bytes       operand + output bytes of every ATen op (eager PyTorch fuses
              nothing: each op reads its inputs from device memory and writes
              its outputs there), views and allocations none, plus each
              kernel launch's ``cost`` bytes;
  coll        output bytes of every collective by the reference's kinds
              (all-gather / all-reduce / reduce-scatter / all-to-all /
              collective-permute): the functional collectives DTensor issues
              (``_c10d_functional``) and the ``torch.distributed`` calls the
              parser's mesh layer makes (``c10d``); ``coll_counts`` of them
              by kind, ``coll_count`` in all;
  kernel_launches  modeled launches by kernel, and by case as
              ``"name/case"`` (K7's ``outputs``), as ``ops.launch_counts``
              names them; ``kernel_bound_s`` their bounds' seconds by
              kernel (``kernel_s`` in all);
  peak_bytes  the largest sum of live storages over the trace, the tensors
              handed to ``track`` (params, optimizer state, caches, batch)
              included: the counterpart of XLA's ``memory_analysis()``
              (arguments + temporaries + outputs − aliases).  The recorder
              counts storages itself: a weak reference to each storage it
              sees, which PyTorch keeps alive exactly as long as the storage
              (its Python object is preserved), so a view keeps its base,
              and a tensor autograd saves for backward counts until backward
              frees it.

On a DTensor program the recorder lets DTensor run first (it returns
``NotImplemented`` for a tensor subclass) and records the local ops and the
collectives DTensor issues: rank 0's program, which stands for every rank's
(DTensor programs are SPMD, as the reference's partitioned HLO is).

A kernel wrapper (``kernels/ops.py``) given meta tensors launches nothing:
under a recorder of the card (``device="cuda"``, the default) it records one
modeled launch with its launcher's ``cost``; under a recorder of the CPU
(``device="cpu"``) it runs its plain version on them, whose ATen ops are
recorded like any other.  A host read of a meta tensor's value
(``aten::_local_scalar_dense``: ``.item()``, ``int()``) cannot run: the
recorder records it, for the lint's host-sync rule, and returns 0.

There are no trip counts: an eager trace runs every iteration.  Where a
program repeats one body n times (the train step's microbatch loop),
:func:`extrapolate` takes the traces of 1 and 2 bodies and gives n:
``one + (n − 1)·(two − one)``, exact for identical bodies; the peak is the
two-body trace's plus what each further body leaves live (the growth of
the live bytes at the end, ``end_bytes``, from one body to two): from the
second body on, each body's live set repeats the one before, plus that.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels import ops as kernel_ops

COLLECTIVE_KINDS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute",
)

# collective ops by schema name; for the in-place c10d ops the output is the
# first argument, for the functional ones the return value
_COLLECTIVES = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::all_gather_into_tensor_out": "all-gather",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allgather_into_tensor_coalesced_": "all-gather",
    "c10d::allreduce_": "all-reduce",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::alltoall_": "all-to-all",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::send": "collective-permute",
}
_IN_PLACE_COLLECTIVE = "c10d::"

# ops that move no bytes and do no flops: allocations and metadata (views
# are found by their schema, ``OpOverload.is_view``)
_FREE = {
    "aten::empty", "aten::empty_strided", "aten::empty_like", "aten::new_empty",
    "aten::new_empty_strided", "aten::lift_fresh", "aten::detach", "aten::alias",
    "aten::_local_scalar_dense", "aten::sym_size", "aten::sym_stride", "aten::sym_numel",
    "aten::is_same_size", "aten::resize_", "aten::set_", "_c10d_functional::wait_tensor",
}
# ops that move bytes but do no arithmetic: copies, gathers, layout changes,
# fills and index arithmetic
_NO_FLOPS = {
    "aten::copy_", "aten::_to_copy", "aten::clone", "aten::cat", "aten::stack",
    "aten::index", "aten::index_select", "aten::gather", "aten::scatter", "aten::index_put",
    "aten::index_put_", "aten::_index_put_impl_", "aten::embedding", "aten::slice_scatter",
    "aten::select_scatter", "aten::constant_pad_nd", "aten::repeat", "aten::flip",
    "aten::roll", "aten::zeros", "aten::zeros_like", "aten::ones", "aten::ones_like",
    "aten::full", "aten::full_like", "aten::fill_", "aten::zero_", "aten::arange",
    "aten::eye", "aten::expand_copy", "aten::scalar_tensor", "aten::_unsafe_index",
    "aten::_unsafe_index_put",
    "aten::embedding_dense_backward", "aten::new_zeros", "aten::new_ones", "aten::new_full",
    "aten::contiguous",
}


@dataclasses.dataclass(frozen=True)
class TracedOp:
    """One ATen op a program ran: its name, the tensors among its inputs
    and outputs as (dtype, shape, device) and, for a copy, its target device."""

    name: str
    inputs: Tuple[Tuple[torch.dtype, Tuple, str], ...]
    outputs: Tuple[Tuple[torch.dtype, Tuple, str], ...]
    to_device: str = ""


def _tensors(xs) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(_tensors(x))
    return out


def _meta(ts) -> Tuple[Tuple[torch.dtype, Tuple, str], ...]:
    return tuple((t.dtype, tuple(t.shape), t.device.type) for t in ts)


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


@dataclasses.dataclass
class OpStats:
    """One traced program's per-rank totals (see the module note)."""

    flops: float = 0.0
    dot_flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})
    coll_counts: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})
    kernel_launches: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_bound_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_flops: float = 0.0
    kernel_bytes: float = 0.0
    peak_bytes: float = 0.0
    end_bytes: float = 0.0         # live when the program returned
    n_ops: float = 0.0

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll.values())

    @property
    def coll_count(self) -> float:
        return sum(self.coll_counts.values())

    @property
    def kernel_s(self) -> float:
        """The modeled launches' bounds, summed over every kernel."""
        return sum(self.kernel_bound_s.values())

    def _combine(self, other: "OpStats", a: float, b: float) -> "OpStats":
        """a·self + b·other, field by field (the peak: the larger)."""
        def mix(x: Dict[str, float], y: Dict[str, float]) -> Dict[str, float]:
            return {k: a * x.get(k, 0) + b * y.get(k, 0) for k in sorted(set(x) | set(y))}

        out = OpStats(
            coll={k: a * self.coll[k] + b * other.coll[k] for k in COLLECTIVE_KINDS},
            coll_counts={k: a * self.coll_counts[k] + b * other.coll_counts[k]
                         for k in COLLECTIVE_KINDS},
            kernel_launches=mix(self.kernel_launches, other.kernel_launches),
            kernel_bound_s=mix(self.kernel_bound_s, other.kernel_bound_s),
            peak_bytes=max(self.peak_bytes, other.peak_bytes),
        )
        for f in ("flops", "dot_flops", "bytes", "kernel_flops", "kernel_bytes", "end_bytes",
                  "n_ops"):
            setattr(out, f, a * getattr(self, f) + b * getattr(other, f))
        return out

    def to_dict(self) -> Dict:
        return {**dataclasses.asdict(self), "coll_bytes": self.coll_bytes,
                "coll_count": self.coll_count, "kernel_s": self.kernel_s}


def extrapolate(one: OpStats, two: OpStats, n: int) -> OpStats:
    """The stats of a program that runs its body ``n`` ≥ 1 times, from
    traces of the same program with 1 and 2 bodies: ``one + (n − 1)·(two −
    one)``; the peak is the two-body trace's, raised by what each further
    body leaves live (``end_bytes``' growth from one body to two)."""
    if n < 1:
        raise ValueError(f"a program of {n} bodies")
    body = two._combine(one, 1.0, -1.0)
    out = one._combine(body, 1.0, float(n - 1))
    out.peak_bytes = one.peak_bytes if n == 1 else two.peak_bytes + (n - 2) * body.end_bytes
    return out


class OpRecorder(TorchDispatchMode):
    """Records one program's ops into ``stats`` (:class:`OpStats`) and
    ``ops`` (:class:`TracedOp`, what ``analyze.program.lint_trace``
    reads).  ``device`` is the device the kernel wrappers model: "cuda"
    (modeled launches) or "cpu" (their plain versions).  With ``meta_only``
    (the default) only ops on meta tensors are the program's: an op whose
    tensors all hold storage is host work around it (a ``DeviceMesh``'s
    bookkeeping, a host step counter) and is not recorded; without it,
    every op is (a program run on real tensors, as the phase lint's
    ``analyze.program.trace_ops`` runs it)."""

    def __init__(self, device: str = "cuda", keep_ops: bool = True, meta_only: bool = True):
        super().__init__()
        if device not in ("cuda", "cpu"):
            raise ValueError(f"a recorder models 'cuda' or 'cpu', got {device!r}")
        self.device = device
        self.keep_ops = keep_ops
        self.meta_only = meta_only
        self.stats = OpStats()
        self.ops: List[TracedOp] = []
        self._live: Dict[int, int] = {}
        self._live_bytes = 0

    # ------------------------------------------------------------ storages

    def track(self, *trees) -> None:
        """Count the storages of every tensor in ``trees`` (nested dicts,
        lists, tuples, NamedTuples; a DTensor by its local tensor) as live
        from now on: a program's arguments."""
        for t in _leaves(trees):
            self._see(t)

    def _see(self, t: torch.Tensor) -> None:
        if hasattr(t, "_local_tensor"):
            t = t._local_tensor
        if not isinstance(t, torch.Tensor) or type(t) not in (torch.Tensor, torch.nn.Parameter):
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self._live_bytes += n
        weakref.finalize(st, self._free, key)
        if self._live_bytes > self.stats.peak_bytes:
            self.stats.peak_bytes = float(self._live_bytes)

    def _free(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    # -------------------------------------------------------------- launches

    def kernel(self, name: str, case: Optional[str], cost) -> None:
        """One modeled launch of kernel ``name`` (``case``: K7's
        ``outputs``) with its launcher's ``cost``."""
        s = self.stats
        for key in (name,) if case is None else (name, f"{name}/{case}"):
            s.kernel_launches[key] = s.kernel_launches.get(key, 0) + 1
        s.kernel_bound_s[name] = s.kernel_bound_s.get(name, 0.0) + cost.seconds
        s.kernel_flops += cost.ops
        s.kernel_bytes += cost.bytes
        s.flops += cost.ops
        s.bytes += cost.bytes

    def __enter__(self):
        kernel_ops.MODELED.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kernel_ops.MODELED.remove(self)
        self.stats.end_bytes = float(self._live_bytes)
        return super().__exit__(*exc)

    # ------------------------------------------------------------------ ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        subclasses = [t for t in types if t is not torch.Tensor and t is not torch.nn.Parameter]
        if subclasses:
            if all(issubclass(t, FakeTensor) for t in subclasses):
                # DTensor's sharding propagation runs ops on fake tensors to
                # learn their shapes: not the program's ops
                return func(*args, **kwargs)
            return NotImplemented       # a subclass (DTensor) runs first, down to local ops
        name = func._schema.name
        ins = _tensors(list(args) + list(kwargs.values()))
        if name == "aten::_local_scalar_dense" and ins and ins[0].device.type == "meta":
            self._note(name, ins, [], "")
            return False if ins[0].dtype == torch.bool else 0
        out = func(*args, **kwargs)
        outs = _tensors(out if isinstance(out, (list, tuple)) else [out])
        if self.meta_only and not any(t.device.type == "meta" for t in ins + outs):
            return out
        s = self.stats
        s.n_ops += 1
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            written = _tensors([args[0]]) if name.startswith(_IN_PLACE_COLLECTIVE) else outs
            s.coll[kind] += _nbytes(written)
            s.coll_counts[kind] += 1
            s.bytes += _nbytes(ins) + _nbytes(outs)
        elif name not in _FREE and not func.is_view:
            s.bytes += _nbytes(ins) + _nbytes(outs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                f = float(formula(*args, **kwargs, out_val=out))
                s.dot_flops += f
                s.flops += f
            elif name not in _NO_FLOPS:
                s.flops += sum(o.numel() for o in outs)
        for o in outs:
            self._see(o)
        to_device = ""
        if name == "aten::_to_copy" and kwargs.get("device") is not None:
            to_device = torch.device(kwargs["device"]).type
        elif name == "aten::copy_" and isinstance(args[0], torch.Tensor):
            to_device = args[0].device.type
        self._note(name, ins, outs, to_device)
        return out

    def _note(self, name, ins, outs, to_device) -> None:
        if self.keep_ops:
            self.ops.append(TracedOp(name, _meta(ins), _meta(outs), to_device))


def _leaves(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


def trace(fn, *args, device: str = "cuda", keep_ops: bool = True, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under a fresh :class:`OpRecorder`
    modeling ``device``, with ``args`` counted live from the start; returns
    (the recorder, fn's result)."""
    rec = OpRecorder(device, keep_ops=keep_ops)
    rec.track(args)
    with rec:
        out = fn(*args, **kwargs)
    return rec, out


def meta_like(tree):
    """Every tensor of a tree (nested dicts, lists, tuples) as an empty
    tensor of its shape, dtype and strides on the meta device; other leaves
    as they are."""
    if isinstance(tree, torch.Tensor):
        return torch.empty_strided(tuple(tree.shape), tuple(tree.stride()), dtype=tree.dtype,
                                   device="meta")
    if isinstance(tree, dict):
        return {k: meta_like(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(meta_like(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(meta_like(v) for v in tree)
    return tree
