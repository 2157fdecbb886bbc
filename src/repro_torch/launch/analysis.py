"""FLOP and byte counter of the port's own trace — the planner's cost
source (``repro.launch.analysis``).

JAX walks jaxprs and multiplies scan bodies by their trip counts. The port
runs eagerly, so its counter watches the aten ops a call really runs, in a
``TorchDispatchMode``: Python loops execute every trip, autograd's backward
ops are seen as they run, and on the ``meta`` device nothing is computed
or allocated. The rules per op are JAX's (``repro/launch/analysis.py``):

  flops       — matmuls exact (2·M·N·K·batch, also by operand dtype in
                ``matmul_flops``); reductions 1 an input element; sort and
                top-k n·log n and n·log k; any other op 1 an output element
  hbm_bytes   — roofline traffic model: operands and results of matmuls,
                sorts and top-k, gathers (twice the rows read), scatters
                (twice the update plus the ids), and program I/O
                (element-wise ops are taken as fused)
  gather_bytes — rows read by gathers and written by scatters
  comm_bytes, unknown_whiles — JAX's fields; always 0 here, as one process
                runs no collective and no loop hides its trip count

A hand-written kernel runs outside aten, so each wrapper of
``kernels/ops.py`` reports its call to the counter: on ``meta`` and on
the card the kernel's own work is charged (the bounds of ``PERF.md`` §6;
its products count as fp32 matmul FLOPs, the entry draw's operations as
int32 ones in ``matmul_flops["int32"]``); on the CPU the plain version's
aten ops are counted as they run. ``kernel_calls`` counts the calls by
kernel and shape. While counting, the live tensor bytes are tracked by
storage, autograd's saved tensors included: their high-water mark is the
planned peak memory of the call, arguments included (the counterpart of
JAX's ``memory_analysis()``). On the card the kernel launches of the call
are counted too, from the same profiler summary ``traced`` prints.

Peaks are the NVIDIA H100 SXM data sheet's dense rates at 700 W: bf16 and
fp16 989.4 TFLOP/s on the tensor cores, fp32 66.9 TFLOP/s on the CUDA
cores (the port's fp32 paths run without TF32), 3.35 TB/s of HBM3, and
NVLink 4 at 450 GB/s a direction; int32 33.45 TOP/s: each SM issues 64
lanes of int32 add, shift, funnel shift and logic ops a clock on its ALU
pipe and 64 of integer multiply-add (an add, to the compiler) on its FMA
pipe, 132 SMs at 1.98 GHz.
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch.sharding import flatten

PEAK_FLOPS = {"bfloat16": 989.4e12, "float16": 989.4e12, "float32": 66.9e12}
PEAK_INT32_OPS = 2 * 132 * 64 * 1.98e9
PEAK_OPS = {**PEAK_FLOPS, "int32": PEAK_INT32_OPS}   # the rate of each kind of operation
HBM_BYTES_PER_S = 3.35e12
NVLINK_BYTES_PER_S = 450e9
CARD_BYTES = 80e9                # H100 SXM HBM3
FIT_FRACTION = 0.9               # of the card a planned peak may fill


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    comm_bytes: float = 0.0
    gather_bytes: float = 0.0
    unknown_whiles: int = 0
    matmul_flops: dict = dataclasses.field(default_factory=dict)   # dtype → FLOPs
    kernel_calls: dict = dataclasses.field(default_factory=dict)   # "name[shape]" → n
    launches: int | None = None  # device kernel launches (on the card only)

    def _combine(self, o: Cost, f) -> Cost:
        out = {}
        for fld in dataclasses.fields(self):
            a, b = getattr(self, fld.name), getattr(o, fld.name)
            if isinstance(a, dict):
                out[fld.name] = {k: f(a.get(k, 0), b.get(k, 0)) for k in {**a, **b}}
            elif a is None or b is None:
                out[fld.name] = None
            else:
                out[fld.name] = f(a, b)
        return Cost(**out)

    def __add__(self, o: Cost) -> Cost:
        return self._combine(o, lambda a, b: a + b)

    def __sub__(self, o: Cost) -> Cost:
        return self._combine(o, lambda a, b: a - b)

    def scale(self, k: float) -> Cost:
        return self._combine(self, lambda a, _: a * k)

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


def _nbytes(t) -> float:
    return float(t.numel()) * t.element_size()


def _tensors(obj) -> list:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)) and all(isinstance(t, torch.Tensor) for t in obj):
        return list(obj)
    return [t for t in tree_leaves(obj) if isinstance(t, torch.Tensor)]


_MATMUL = {"mm", "bmm", "addmm", "baddbmm"}
_GATHER = {"index", "_unsafe_index", "index_select", "gather", "embedding"}
# (position of the update, position of the ids) in the op's arguments
_SCATTER = {**dict.fromkeys(("index_add", "index_add_", "scatter_add", "scatter_add_",
                             "scatter_reduce", "scatter_reduce_", "scatter", "scatter_",
                             "index_copy", "index_copy_"), (3, 2)),
            **dict.fromkeys(("index_put", "index_put_", "_index_put_impl_"), (2, 1)),
            "embedding_dense_backward": (0, 1)}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin",
           "cumsum", "cumprod", "cummax", "cummin", "logsumexp", "any", "all",
           "linalg_vector_norm", "norm", "var", "std"}
_SORT = {"sort", "argsort"}
# layout, movement, creation, casts and selects: free, as JAX's
# broadcast/reshape/transpose/convert/slice/concatenate/pad/iota/select_n
_FREE = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "permute", "transpose", "t",
    "expand", "squeeze", "unsqueeze", "slice", "select", "split", "split_with_sizes",
    "unbind", "chunk", "narrow", "as_strided", "diagonal", "detach", "alias", "clone",
    "_to_copy", "copy", "copy_", "cat", "stack", "constant_pad_nd", "flip", "repeat",
    "empty", "empty_like", "empty_strided", "zeros", "zeros_like", "ones", "ones_like",
    "full", "full_like", "new_empty", "new_empty_strided", "new_zeros", "new_ones",
    "new_full", "arange", "scalar_tensor", "lift_fresh", "lift_fresh_copy", "where",
    "masked_fill", "masked_fill_", "fill", "fill_", "zero_", "_local_scalar_dense",
    "slice_backward", "select_backward",
}


def _matmul(name: str, args) -> tuple[float, str]:
    """(2·M·N·K·batch, the operands' dtype name)."""
    a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") else (args[0], args[1])
    batch = a.shape[0] if a.dim() == 3 else 1
    return (2.0 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1],
            str(a.dtype).removeprefix("torch."))


def _charge(cost: Cost, name: str, args, outs: list) -> None:
    if name in _FREE:
        return
    if not outs and name.endswith("_") and args:       # in place, returns nothing
        outs = _tensors(args[0])
    out_bytes = sum(_nbytes(t) for t in outs)
    if name in _MATMUL:
        f, dt = _matmul(name, args)
        cost.flops += f
        cost.matmul_flops[dt] = cost.matmul_flops.get(dt, 0.0) + f
        cost.hbm_bytes += sum(_nbytes(t) for t in _tensors(args)) + out_bytes
    elif name in _GATHER:
        cost.hbm_bytes += 2 * out_bytes        # index read + row read ≈ result
        cost.gather_bytes += out_bytes
    elif name in _SCATTER:
        # touched elements (read + write) and the ids, not a rewrite of the
        # whole result
        ui, ii = _SCATTER[name]
        upd = args[ui] if len(args) > ui else None
        idx = sum(_nbytes(t) for t in _tensors(args[ii]))
        if isinstance(upd, torch.Tensor) and upd.numel() > 1:
            upd_bytes = _nbytes(upd)
        else:                                  # a broadcast scalar update
            n = max((t.numel() for t in _tensors(args[ii])), default=0)
            upd_bytes = float(n) * outs[0].element_size() if outs else 0.0
        cost.hbm_bytes += 2 * upd_bytes + idx
        cost.gather_bytes += upd_bytes
    elif name in _SORT:
        n = float(args[0].numel())
        cost.flops += n * max(math.log2(max(n, 2)), 1)
        cost.hbm_bytes += _nbytes(args[0]) + out_bytes
    elif name == "topk":
        n = float(args[0].numel())
        cost.flops += n * math.log2(max(args[1], 2))
        cost.hbm_bytes += _nbytes(args[0]) + out_bytes
    elif name in _REDUCE:
        cost.flops += float(args[0].numel())
    else:                                      # element-wise: 1 an output element
        cost.flops += float(sum(t.numel() for t in outs))


class _LiveBytes:
    """Bytes of the storages alive, by storage (views share one), with
    their high-water mark. A storage is dead once no tensor holds it,
    autograd's saved ones included. The dead are reclaimed only when an
    allocation could raise the mark, newest first (temporaries die young),
    until it cannot: the mark is exact."""

    def __init__(self):
        self.refs: dict = {}
        self.cur = 0
        self.peak = 0

    def _reclaim(self, need: int) -> None:
        dead = []
        for key, (w, n) in reversed(self.refs.items()):
            if w.expired():
                dead.append(key)
                self.cur -= n
                if self.cur + need <= self.peak:
                    break
        for key in dead:
            del self.refs[key]

    def add(self, tensors) -> None:
        for t in tensors:
            st = t.untyped_storage()
            key = st._cdata
            old = self.refs.get(key)
            if old is not None:
                if not old[0].expired():
                    continue
                self.cur -= self.refs.pop(key)[1]          # a reused address
            n = st.nbytes()
            if self.cur + n > self.peak:
                self._reclaim(n)
            self.refs[key] = (StorageWeakRef(st), n)
            self.cur += n
            self.peak = max(self.peak, self.cur)


# element-wise ops whose output on ``meta`` the counter makes itself: torch's
# meta functions for them run in Python at ~0.3 ms a call, which an LM's
# attention loop calls millions of times at 32k tokens
_BOOL_OUT = {"eq", "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or",
             "logical_not", "logical_xor", "isnan", "isinf", "isfinite"}
_FLOAT_OUT = {"exp", "log", "sqrt", "rsqrt", "tanh", "sigmoid", "sin", "cos",
              "reciprocal"}
_PROMOTE = {"add", "sub", "mul", "maximum", "minimum", "abs", "neg", "clamp",
            "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not"}


def _broadcast(shapes) -> tuple | None:
    nd = max(len(s) for s in shapes)
    out = [1] * nd
    for s in shapes:
        for j, n in enumerate(s, nd - len(s)):
            if n != 1:
                if out[j] not in (1, n):
                    return None
                out[j] = n
    return tuple(out)


_POINTWISE = {**dict.fromkeys(_BOOL_OUT, "bool"), **dict.fromkeys(_FLOAT_OUT, "float"),
              **dict.fromkeys(_PROMOTE, "promote"), "where": "where"}


def _promote(operands) -> torch.dtype:
    """torch's type promotion over tensors and numbers."""
    if len(operands) == 1:
        return operands[0].dtype
    dtype = torch.result_type(operands[0], operands[1])
    if len(operands) > 2:                       # clamp's min and max
        dims = any(isinstance(o, torch.Tensor) and o.dim() > 0 for o in operands[:2])
        for o in operands[2:]:
            acc = torch.empty((1,) if dims else (), dtype=dtype, device="meta")
            dtype = torch.result_type(acc, o)
    return dtype


def _meta_pointwise(name: str, args, kwargs):
    """The output of an element-wise op over meta tensors, by broadcasting
    and type promotion; None where torch's own meta function must run."""
    kind = _POINTWISE.get(name)
    if kind is None or kwargs.get("out") is not None:
        return None
    shapes = []
    for a in args:
        if isinstance(a, torch.Tensor):
            if a.device.type != "meta":
                return None
            shapes.append(a.shape)
    shape = _broadcast(shapes) if shapes else None
    if shape is None:
        return None
    if kind == "bool":
        dtype = torch.bool
    else:
        dtype = _promote(args[1:3] if kind == "where" else [a for a in args if a is not None])
        if kind == "float" and not dtype.is_floating_point:
            return None
    return torch.empty(shape, dtype=dtype, device="meta")


_NAMES: dict = {}               # aten op → its packet's name


class _Counter(TorchDispatchMode):
    def __init__(self, cost: Cost, live: _LiveBytes):
        super().__init__()
        self.cost, self.live = cost, live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _NAMES.get(func) or _NAMES.setdefault(func, func.overloadpacket.__name__)
        out = _meta_pointwise(name, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
        outs = _tensors(out)
        _charge(self.cost, name, args, outs)
        self.live.add(outs)
        return out

    def observe(self, name, device_type, flops, nbytes, shape, dtype="float32") -> None:
        key = f"{name}{list(shape)}"
        self.cost.kernel_calls[key] = self.cost.kernel_calls.get(key, 0) + 1
        if device_type == "cpu":               # the plain version's ops count
            return
        self.cost.flops += flops
        self.cost.matmul_flops[dtype] = self.cost.matmul_flops.get(dtype, 0.0) + flops
        self.cost.hbm_bytes += nbytes


@dataclasses.dataclass
class Trace:
    cost: Cost
    peak_bytes: int        # high-water mark of live tensor bytes, args included
    arg_bytes: int         # bytes of the arguments' storages
    seconds: float         # host time of the counted call


def trace(fn, *args, io_bytes: bool = True) -> Trace:
    """Run ``fn(*args)`` once under the counter (tensors on ``meta``, the
    CPU or the card); on the card also count its kernel launches."""
    cost, live = Cost(), _LiveBytes()
    arg_tensors = flatten(args)
    live.add(arg_tensors)
    arg_bytes = live.cur
    on_card = any(t.device.type == "cuda" for t in arg_tensors)
    counter = _Counter(cost, live)

    def counted():
        with counter:
            return fn(*args)

    kernel_ops.observer = counter.observe
    t0 = time.perf_counter()
    try:
        if on_card:
            out, cost.launches = _launches(counted)
        else:
            out = counted()
    finally:
        kernel_ops.observer = None
    seconds = time.perf_counter() - t0
    if io_bytes:
        cost.hbm_bytes += sum(_nbytes(t) for t in arg_tensors)
        cost.hbm_bytes += sum(_nbytes(t) for t in flatten(out))
    return Trace(cost, live.peak, arg_bytes, seconds)


def _launches(run):
    """(run(), the device kernels it launched), from a profile of the card
    alone (host-side op records would cost more than the ops)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    return out, sum(c for _, c, _ in device_kernels(prof))


def count_launches(fn, *args) -> int:
    """The device kernels one call of ``fn(*args)`` launches (the card only)."""
    return _launches(lambda: fn(*args))[1]


def cost_of(fn, *args, io_bytes: bool = True) -> Cost:
    """The :class:`Cost` of one call of ``fn(*args)``."""
    return trace(fn, *args, io_bytes=io_bytes).cost


def bound_ms(flops: float, nbytes: float, dtype: str = "float32") -> tuple[float, str]:
    """(the least time one card takes for this work, in ms; "operations"
    or "bytes", whichever takes it): the larger of the operations at the
    dtype's peak and the bytes at the HBM rate."""
    t_ops = flops / PEAK_OPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def roofline(cost: Cost, collective_bytes: float, n_devices: int = 1) -> dict:
    """Seconds per device of the three roofline terms at the H100's peaks,
    and the dominant one; FLOPs and bytes split evenly over the devices,
    collective bytes are per device already (JAX's model charges them at
    one device too; one card has no link to cross, so its term is 0)."""
    mm = sum(cost.matmul_flops.values())
    compute = sum(f / PEAK_OPS.get(dt, PEAK_FLOPS["float32"])
                  for dt, f in cost.matmul_flops.items())
    compute += (cost.flops - mm) / PEAK_FLOPS["float32"]
    terms = {"compute_s": compute / n_devices,
             "memory_s": cost.hbm_bytes / n_devices / HBM_BYTES_PER_S,
             "collective_s": collective_bytes / NVLINK_BYTES_PER_S if n_devices > 1 else 0.0}
    return {**terms, "dominant": max(terms, key=terms.get).removesuffix("_s")}


# ---------------------------------------------------------------------------
# profiler summaries (the card only)
# ---------------------------------------------------------------------------

# kernel-name fragments by kind (cuBLAS/CUTLASS GEMMs; the reductions and
# softmax of the attention; element-wise and copy kernels)
KINDS = (("matmul", ("gemm", "gemv", "sm90_xmma", "cutlass", "splitK", "Kernel2")),
         ("reduce_softmax", ("reduce", "softmax", "max")),
         ("elementwise_copy", ("elementwise", "copy", "Copy", "index", "cat", "fill",
                               "where")))
UNTRACED_RUNS = 10
_ACTIVITIES = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def untraced_ms(fn, runs: int = UNTRACED_RUNS) -> float:
    """Median wall time of synchronised runs of ``fn``, no profiler on."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return sorted(times)[len(times) // 2]


def device_kernels(prof) -> list[tuple[float, int, str]]:
    """(device µs, launches, name) of every kernel in a profile."""
    out = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us and ev.device_type == torch.autograd.DeviceType.CUDA:
            out.append((dev_us, ev.count, ev.key))
    return out


def traced(fn) -> dict:
    """One traced, synchronised run of ``fn`` (after two untraced ones),
    beside the median untraced wall time that its busy share divides."""
    for _ in range(2):
        fn()
    wall_untraced = untraced_ms(fn)
    with torch.profiler.profile(activities=_ACTIVITIES) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels, by_kind = [], {}
    busy, launches = 0.0, 0
    for dev_us, count, key in device_kernels(prof):
        busy += dev_us
        launches += count
        kernels.append((dev_us, count, key[:90]))
        k = kind_of(key)
        by_kind[k] = by_kind.get(k, 0.0) + dev_us / 1e3
    kernels.sort(reverse=True)
    return {"wall_ms": wall_untraced, "traced_wall_ms": wall * 1e3,
            "device_busy_ms": busy / 1e3,
            "busy_share": busy / 1e3 / wall_untraced if wall_untraced > 0 else None,
            "kernel_launches": launches, "device_ms_by_kind": by_kind,
            "top": [{"kernel": k, "device_ms": us / 1e3, "count": c}
                    for us, c, k in kernels[:8]]}
