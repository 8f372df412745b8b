"""Flops, bytes and collective wire bytes of the aten program a call runs.

Counterpart of ``repro/dist/hlo_cost.py``.  The reference walks optimized
HLO text; the port has no HLO: its program is the sequence of aten ops it
executes.  :func:`record` plays the part of ``parse_module``: it runs
``fn`` once under ``FakeTensorMode``, on fake CPU copies of every tensor
argument, with a ``TorchDispatchMode`` that records each op: its name, the
shapes and dtypes of its inputs and outputs, its cost, and, for a
collective, its kind and group size.  The caller's tensors are never
touched and nothing is allocated on any device.  On fake CPU tensors every
kernel wrapper takes its plain path, so the count bills the plain path's
ops, as the reference's dry run bills its jax path.  Nothing of the
counted program runs anywhere.

Counting rules, the reference's mapped to aten:

* matrix products (``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolutions,
  ``_scaled_dot_product_*``): ``torch.utils.flop_counter``'s formulas,
  which are the reference's ``2 * |out| * K``
* elementwise: ``|out|`` flops; transcendentals (``exp``, ``log``,
  ``tanh``, ``sqrt``, ``rsqrt``, ``pow``, ...) counted apart, as XLA does;
  fused pointwise ops (``silu``, ``gelu``, their backwards) as the sum of
  the parts the reference would see
* reductions: ``|in| - |out|``; softmax and log-softmax as their max, sum
  and pointwise parts
* scatter-adds (``index_add``, ``index_put(accumulate=True)``,
  ``scatter_add``, ``embedding_dense_backward``): ``|updates|``
* views, ``wait_tensor`` and factories: free (no flops, no bytes)
* data movement (``copy_``, ``cat``, ``index``, ``gather``,
  ``embedding``, ``_to_copy``, ...): bytes only
* collectives: zero flops; wire bytes by ``hlo_analysis.CollectiveOp``
  (all-reduce: the tensor; all-gather: the gathered output;
  reduce-scatter: the output shard; all-to-all: its output)

Bytes are the inputs plus the outputs of every op that is not free: the
eager program's traffic, one kernel per op.  That is not XLA's traffic at
fusion boundaries, so bytes are not comparable with the reference's.  An
op no rule names is charged bytes only, as the reference charges an
unknown opcode, and its name goes into :attr:`Program.unknown`, so a count
with holes shows them.  Loops are counted trip by trip, because they
execute: what the reference recovers from ``known_trip_count``.

Under a mesh the count is per rank, as the reference's is per device.  A
``DTensor``-level op is not billed: the recorder hands it on to DTensor's
dispatch and bills the ops DTensor runs on the local shards, and the
collectives of every redistribution, implicit ones included.  DTensor's
sharding propagation also runs each op at its global shapes on fake
tensors; those calls are not the program and are skipped (they are the
ones made from ``torch/distributed/tensor/_sharding_prop.py``).

On a CPU mesh DTensor turns a shard-to-shard redistribution, an all-to-all
on a CUDA mesh, into an all-gather and a chunk (gloo has no all-to-all).
The count keeps what ran: an all-gather of the whole tensor, ``D`` times
the all-to-all's bytes.  :attr:`Program.cpu_alltoall_as_allgather` counts
those redistributions, and ``launch/dryrun.py`` writes the count beside
the totals.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
import weakref
from typing import Any, Dict, List, Optional, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch import is_dtensor
from repro_torch.dist.hlo_analysis import CollectiveOp

# elementwise ops billed at one flop per output element (XLA's default)
_FLOP1 = {
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "sign", "sgn",
    "maximum", "minimum", "clamp", "clamp_min", "clamp_max", "where",
    "eq", "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or",
    "logical_not", "logical_xor", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "__and__", "__or__", "__xor__", "floor",
    "ceil", "round", "trunc", "frac", "remainder", "fmod", "isfinite",
    "isnan", "isinf", "reciprocal", "square", "relu", "masked_fill",
    "copysign", "nan_to_num", "signbit", "floor_divide",
    "threshold_backward", "hardtanh",
}
# billed as transcendentals, NOT flops (matches XLA's 'flops' property)
_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh",
    "sigmoid", "sqrt", "rsqrt", "pow", "erf", "erfc", "erfinv", "sin",
    "cos", "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh",
}
# fused pointwise ops: (flops, transcendentals) per output element, the
# parts the reference's HLO would show for the same function
_POINTWISE = {
    "silu": (1, 1),                  # x * sigmoid(x)
    "silu_backward": (4, 1),         # g * s * (1 + x (1 - s))
    "sigmoid_backward": (3, 0),      # g * y * (1 - y)
    "tanh_backward": (3, 0),         # g * (1 - y * y)
    "gelu": (7, 1),                  # tanh approximation
    "gelu_backward": (14, 2),
    "softplus": (1, 2),              # log1p(exp(x))
    "softplus_backward": (3, 1),     # g / (1 + exp(-x))
    "lerp": (3, 0),
    "addcmul": (2, 0),
    "addcdiv": (2, 0),
}
# reductions and their kin: (a, b, c, d) -> a|in| + b|out| flops and
# c|in| + d|out| transcendentals; a plain reduction is |in| - |out|
_REDUCE = {
    **{name: (1, -1, 0, 0) for name in (
        "sum", "nansum", "amax", "amin", "max", "min", "prod", "argmax",
        "argmin", "all", "any", "cumsum", "cumprod")},
    "mean": (1, 0, 0, 0),                  # the sum, then a divide a row
    "logsumexp": (3, -1, 1, 1),            # max, sub, exp, sum, log, add
    "linalg_vector_norm": (2, -1, 0, 1),   # square, sum, sqrt
    "var": (3, 0, 0, 0), "std": (3, 0, 0, 1), "var_mean": (3, 0, 0, 0),
}
# scatter-adds: |updates| flops; the updates are this positional argument
_SCATTER = {"index_add": 3, "scatter_add": 3, "scatter_reduce": 3,
            "embedding_dense_backward": 0, "index_put": 2}
# pure bookkeeping: zero flops, zero bytes (views are found by schema)
_FREE = {"wait_tensor", "_wrap_tensor_autograd", "_unsafe_view", "detach",
         "lift_fresh", "resize", "set",
         "empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "zeros", "zeros_like", "ones", "ones_like",
         "full", "full_like", "new_zeros", "new_ones", "new_full", "arange",
         "scalar_tensor", "randn", "randn_like", "rand", "rand_like",
         "randint", "randperm", "eye", "linspace"}
# data movement billed by bytes only
_MOVE = {
    "copy", "_to_copy", "clone", "cat", "stack", "index", "_unsafe_index",
    "index_select", "gather", "embedding", "index_copy", "slice_scatter",
    "select_scatter", "as_strided_scatter", "select_backward",
    "slice_backward", "index_select_backward", "constant_pad_nd", "pad",
    "repeat", "repeat_interleave", "flip", "roll", "tril", "triu",
    "masked_select", "masked_scatter", "scatter", "sort", "argsort", "topk",
    "nonzero", "fill", "zero", "bernoulli", "native_dropout", "normal",
    "uniform", "one_hot", "searchsorted", "bucketize",
}

# collectives: c10d ops take their billed tensors first and a process
# group object; functional ops return the billed tensor and name the group
_C10D = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "allgather_": "all-gather", "_allgather_base_": "all-gather",
         "allgather_coalesced_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "reduce_scatter_tensor_coalesced_": "reduce-scatter",
         "alltoall_": "all-to-all", "alltoall_base_": "all-to-all"}
_FUNCTIONAL = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
               "all_reduce_coalesced": "all-reduce",
               "all_reduce_coalesced_": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_out": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_out": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               "shard_dim_alltoall": "all-to-all"}
_FUNCTIONAL_NS = ("_c10d_functional", "_c10d_functional_autograd",
                  "_dtensor")


@dataclasses.dataclass(frozen=True)
class Op:
    """One executed op: name, (dtype, shape) of inputs and outputs, cost."""
    name: str
    inputs: Tuple[Tuple[str, Tuple[int, ...]], ...]
    outputs: Tuple[Tuple[str, Tuple[int, ...]], ...]
    flops: float = 0.0
    transcendentals: float = 0.0
    bytes: float = 0.0
    collective: Optional[CollectiveOp] = None

    def line(self) -> str:
        def fmt(ts):
            return ", ".join(f"{dt}{list(sh)}" for dt, sh in ts)
        coll = (f" {self.collective.kind} D={self.collective.group_size}"
                f" wire={self.collective.wire_bytes:.0f}"
                if self.collective is not None else "")
        return (f"{self.name}({fmt(self.inputs)}) -> ({fmt(self.outputs)})"
                f" flops={self.flops:.0f} trans={self.transcendentals:.0f}"
                f" bytes={self.bytes:.0f}{coll}")


@dataclasses.dataclass
class Program:
    """What one call executed, per rank (:func:`record`)."""
    ops: List[Op] = dataclasses.field(default_factory=list)
    unknown: Set[str] = dataclasses.field(default_factory=set)
    seconds: float = 0.0
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_bytes: int = 0
    flop_counter: float = 0.0
    cpu_alltoall_as_allgather: int = 0

    def text(self) -> str:
        """The program, one op a line."""
        return "\n".join(op.line() for op in self.ops) + "\n"


# ---------------------------------------------------------------------------
# per-op costs


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _sig(ts) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
    return tuple((_dtype_name(t.dtype), tuple(t.shape)) for t in ts)


def _group_size(args) -> int:
    from torch.distributed import ProcessGroup
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, ProcessGroup):
            return a.size()
        if (isinstance(a, torch.ScriptObject) and a._type().qualified_name()
                .endswith(".c10d.ProcessGroup")):
            return ProcessGroup.unbox(a).size()
    for a in reversed(args):
        if isinstance(a, str):
            return _resolve_process_group(a).size()
    raise ValueError("collective names no process group")


def _collective(ns: str, name: str, args, out) -> Optional[CollectiveOp]:
    if ns == "c10d" and name in _C10D:
        billed = _tensors(args[0])
        kind = _C10D[name]
    elif ns in _FUNCTIONAL_NS and name in _FUNCTIONAL:
        billed = _tensors(out)
        kind = _FUNCTIONAL[name]
    else:
        return None
    return CollectiveOp(kind, float(sum(_nbytes(t) for t in billed)),
                        _group_size(args))


def _base_name(name: str) -> str:
    """``add_`` -> ``add``; ``__and__`` and ``_to_copy`` stay."""
    if name.endswith("_") and not name.endswith("__"):
        return name[:-1]
    return name


def _softmax_cost(name: str, x: torch.Tensor, dim: int):
    n = x.numel()
    rows = n // max(x.shape[dim] if x.ndim else 1, 1)
    if name == "_softmax":          # max, sub, exp, sum, div
        return 4 * n - 2 * rows, n
    if name == "_log_softmax":      # max, sub, exp, sum, log, sub
        return 4 * n - 2 * rows, n + rows
    if name == "_softmax_backward_data":   # y * (g - sum(g * y))
        return 4 * n - rows, 0
    return 3 * n - rows, n          # g - exp(y) * sum(g)


def _cost(func, args, kwargs, out, unknown: Set[str]) -> Op:
    ns = func.namespace
    packet = func.overloadpacket
    name = packet.__name__
    base = _base_name(name)
    ins, outs = _tensors((args, kwargs)), _tensors(out)
    sig_in, sig_out = _sig(ins), _sig(outs)
    full = f"{ns}.{name}.{func._overloadname}"
    if func.is_view or base in _FREE:
        return Op(full, sig_in, sig_out)
    io = float(sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs))
    coll = _collective(ns, name, args, out)
    if coll is not None:
        return Op(full, sig_in, sig_out, bytes=io, collective=coll)
    out_elems = outs[0].numel() if outs else 0
    flops = trans = 0.0
    if packet in flop_registry:
        flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
    elif ns != "aten":
        unknown.add(full)
    elif base in _TRANSCENDENTAL:
        trans = out_elems
    elif base in _FLOP1:
        flops = out_elems
    elif base in _POINTWISE:
        f, t = _POINTWISE[base]
        flops, trans = f * out_elems, t * out_elems
    elif base in _REDUCE:
        a, b, c, d = _REDUCE[base]
        n = ins[0].numel()
        flops = max(a * n + b * out_elems, 0)
        trans = c * n + d * out_elems
    elif base in ("_softmax", "_log_softmax", "_softmax_backward_data",
                  "_log_softmax_backward_data"):
        flops, trans = _softmax_cost(base, ins[0],
                                     _dim_arg(base, args, ins[0]))
    elif base in _SCATTER:
        if base == "index_put" and not _accumulate(args, kwargs):
            pass                    # a plain write: bytes only
        else:
            flops = _tensors(args[_SCATTER[base]])[0].numel()
    elif base not in _MOVE:
        unknown.add(full)
    return Op(full, sig_in, sig_out, float(flops), float(trans), io)


def _dim_arg(base: str, args, x: torch.Tensor) -> int:
    # _softmax(x, dim, half_to_float); _softmax_backward_data(g, y, dim, dt)
    dim = args[1] if base in ("_softmax", "_log_softmax") else args[2]
    return dim % max(x.ndim, 1)


def _accumulate(args, kwargs) -> bool:
    return bool(kwargs.get("accumulate", args[3] if len(args) > 3 else False))


# ---------------------------------------------------------------------------
# the recorder


def _dtensor_internals(depth: int = 48) -> Tuple[bool, bool]:
    """(made by DTensor's sharding propagation, made by its shard-offset
    arithmetic) for the op being dispatched.  Propagation runs each op at
    its global shapes to learn the output's metadata; the offset
    arithmetic of a strided shard lists an index tensor on the host."""
    f, prop, offsets = sys._getframe(2), False, False
    while f is not None and depth:
        code = f.f_code
        prop = prop or code.co_filename.endswith("_sharding_prop.py")
        offsets = offsets or code.co_name == "local_shard_size_and_offset"
        f, depth = f.f_back, depth - 1
    return prop, offsets


class _Recorder(TorchDispatchMode):
    def __init__(self, program: Program):
        super().__init__()
        self.program = program
        self.live = program.argument_bytes
        program.peak_bytes = self.live

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented   # DTensor runs it on the local shards
        prop, offsets = _dtensor_internals()
        if offsets and not any(_mode_of(t) for t in _tensors((args, kwargs))):
            # index arithmetic DTensor reads on the host: real, and small
            from torch._subclasses.fake_tensor import unset_fake_temporarily
            with unset_fake_temporarily():
                return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if func.namespace == "prim" or prop:
            return out
        self.program.ops.append(_cost(func, args, kwargs, out,
                                      self.program.unknown))
        # live bytes: every fresh (non-aliasing) output until it dies
        rets = func._schema.returns
        pairs = ([(t, rets[0]) for t in _tensors(out)] if len(rets) == 1
                 else zip(out, rets))
        for t, ret in pairs:
            if isinstance(t, torch.Tensor) and ret.alias_info is None:
                n = _nbytes(t)
                self.live += n
                weakref.finalize(t, self._free, n)
        self.program.peak_bytes = max(self.program.peak_bytes, self.live)
        return out


def _is_dtensor_type(t) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and issubclass(t, mod.DTensor)


@contextlib.contextmanager
def _count_cpu_alltoalls(program: Program):
    """Count DTensor's all-gather + chunk stand-ins for an all-to-all."""
    pt = sys.modules.get("torch.distributed.tensor.placement_types")
    inner = getattr(pt, "shard_dim_alltoall", None)
    if inner is None:
        yield
        return

    def counted(x, gather_dim, shard_dim, mesh, mesh_dim):
        if mesh.device_type == "cpu":
            program.cpu_alltoall_as_allgather += 1
        return inner(x, gather_dim, shard_dim, mesh, mesh_dim)

    pt.shard_dim_alltoall = counted
    try:
        yield
    finally:
        pt.shard_dim_alltoall = inner


def fake_mode():
    """A ``FakeTensorMode`` to build a recording's inputs in."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def _mode_of(tree) -> Optional[Any]:
    for t in _tensors(tree):
        local = t._local_tensor if is_dtensor(t) else t
        mode = getattr(local, "fake_mode", None)
        if mode is not None:
            return mode
    return None


def fake_cpu(tree, mode):
    """Fake CPU copies (shape, dtype, stride) of every tensor of ``tree``,
    made in ``mode``; a tensor already fake in ``mode`` (a ``DTensor`` of
    fake shards included) is kept.  Reads no data of the originals."""
    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(one(v) for v in x)
        if not isinstance(x, torch.Tensor):
            return x
        if _mode_of(x) is mode:
            return x
        if is_dtensor(x):
            raise TypeError("a DTensor is recorded only when its shards "
                            "were made in the recording's fake mode")
        with mode:
            t = torch.empty_strided(tuple(x.shape), tuple(x.stride()),
                                    dtype=x.dtype, device="cpu")
        return t.requires_grad_(x.requires_grad)
    return one(tree)


def _local_bytes(tree) -> int:
    return sum(_nbytes(t._local_tensor if is_dtensor(t) else t)
               for t in _tensors(tree))


def record(fn, *args, **kwargs) -> Program:
    """Run ``fn(*args, **kwargs)`` once on fake CPU copies of its tensors
    and return the :class:`Program` it executed.

    Arguments already fake (built in a :func:`fake_mode`, e.g. params
    placed on a mesh of a fake process group) are used as they are, in
    their own mode.  An exception of ``fn`` propagates: a program that
    cannot run on fake tensors (a host read of a value) has no count.
    """
    mode = _mode_of((args, kwargs)) or fake_mode()
    args, kwargs = fake_cpu((args, kwargs), mode)
    program = Program(argument_bytes=_local_bytes((args, kwargs)))
    counter = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with mode, _count_cpu_alltoalls(program), counter, _Recorder(program):
        out = fn(*args, **kwargs)
    program.seconds = time.perf_counter() - t0
    program.output_bytes = _local_bytes(out)
    program.flop_counter = float(counter.get_total_flops())
    return program


def analyze(program, *args, **kwargs) -> Dict[str, float]:
    """A :class:`Program` (or ``fn, *args``, recorded first) -> the
    reference's cost summary ``{"flops", "transcendentals", "bytes",
    "collective_bytes"}``, all per rank."""
    if not isinstance(program, Program):
        program = record(program, *args, **kwargs)
    return {
        "flops": sum(op.flops for op in program.ops),
        "transcendentals": sum(op.transcendentals for op in program.ops),
        "bytes": sum(op.bytes for op in program.ops),
        "collective_bytes": sum(op.collective.wire_bytes
                                for op in program.ops
                                if op.collective is not None),
    }


def init_fake_world(n_ranks: int, rank: int = 0) -> None:
    """Make this process rank ``rank`` of a fake process group of
    ``n_ranks``: collectives run on fake tensors and send nothing.  The
    default group is process-wide."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n_ranks)


@contextlib.contextmanager
def fake_world(n_ranks: int, rank: int = 0):
    """:func:`init_fake_world` for the ``with`` block; the group is
    destroyed on exit."""
    import torch.distributed as dist
    init_fake_world(n_ranks, rank)
    try:
        yield
    finally:
        dist.destroy_process_group()
