"""GraphDef executor: run TF inference graphs with torch ops.

`tensorflow_model_server` executes whatever graph the SavedModel carries
(meta_graph.proto:31-87, graph.proto:14; the repo vendors the IDL, this
module supplies the execution semantics). The zoo importer
(interop/savedmodel.py) binds weights onto a known architecture; this
executor serves exports whose architecture is NOT in the zoo: the exported
GraphDef (main graph + FunctionDefLibrary) is interpreted node by node, each
node a torch op on the servable's device, so batching, versioning and the
wire protocol stay those of any zoo model.

Scope (documented, enforced) — the JAX package's executor's:
- Inference dataflow ops (the `_OPS` table: MatMul/BiasAdd/activations/
  Gather/Reshape/Concat/reductions/elementwise/StridedSlice/Select/Cast/
  Einsum/...).
- TF2 function calls (PartitionedCall/StatefulPartitionedCall and direct
  function-name ops) with captured variable handles, recursively.
- Variables via VarHandleOp/ReadVariableOp (TF2) or VariableV2/Identity
  (TF1, yielding the value directly), bound by shared_name / node name to
  extracted checkpoint values.
- Static hash tables (tf.lookup.StaticHashTable over integer keys with
  KeyValueTensorInitializer): contents are resolved statically from the
  export's initializer call chain into sorted key/value arrays, held on the
  device once; LookupTableFindV2 is torch.searchsorted + an equality
  select, no host callback.
- Constant-predicate conditionals (If/StatelessIf/Case whose predicate the
  graph fixes at import): the chosen branch is inlined.
- NOT supported (UnsupportedOpError naming the node): data-dependent
  control flow (an If on a live predicate, While/loops),
  TensorList/TensorArray, stateful mutation, sparse ops, string
  processing, mutable/file-backed/string-keyed tables.

Static and live values. A host numpy array is static: Consts, shapes and
what is computed from them alone, folded with numpy on the host exactly as
the reference folds them, so shape arithmetic (Shape -> StridedSlice ->
Pack -> Reshape, Range, Fill) never touches the device. A torch tensor is
live: the feeds and the variables, on the servable's device, and every node
that reads one runs as torch ops there. A host value that meets a live one
moves to the device (a 0-d one as a fill, a graph constant once per device
and then cached), and nothing live is ever read back to decide a shape, an
index or a branch: a warm call makes no host-device synchronization.

Numerics: torch is 64-bit natively, so int64 ids past 2^31 and float64
tensors reach the graph as they are; `needs_x64` marks a model whose graph
carries them, and the batcher then keeps float64 inputs and full-precision
outputs. Output dtypes follow the reference's: its live nodes are jnp ops
under enable_x64 (an integer divide or mean widens to float32 below 64
bits, Cumsum keeps the input's dtype), its static nodes numpy. Gelu is the
tanh approximation (jax.nn.gelu's default) whatever the node's
`approximate` attribute says, and Cumsum ignores `exclusive` and
`reverse`, as in the reference.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch
import torch.nn.functional as F

from .. import codec
from ..models.base import Model, ModelConfig, resolve_device

log = logging.getLogger("dts_torch.graph_exec")


class UnsupportedOpError(RuntimeError):
    """The graph uses an op outside the executor's documented scope."""


class GraphExecError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class VarRef:
    """A resource handle flowing through the graph: resolves to params[key]
    at ReadVariableOp / ResourceGather sites."""

    key: str


@dataclasses.dataclass(frozen=True)
class TableRef:
    """A hash-table resource handle (HashTableV2): resolves to the statically
    extracted (sorted_keys, sorted_values) at LookupTableFindV2 sites."""

    key: str


def _attr(node, name, default=None):
    if name in node.attr:
        return node.attr[name]
    return default


def _np_dtype(dt_enum: int) -> np.dtype:
    return codec.dtype_to_numpy(dt_enum)


# DataType -> torch dtype, for Cast / ArgMax / Shape out_type on live values.
_TORCH_DTYPES = {
    1: torch.float32, 2: torch.float64, 3: torch.int32, 4: torch.uint8,
    5: torch.int16, 6: torch.int8, 9: torch.int64, 10: torch.bool,
    14: torch.bfloat16, 19: torch.float16,
}

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16, np.dtype(np.int64): torch.int64,
    np.dtype(np.int32): torch.int32, np.dtype(np.int16): torch.int16,
    np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool,
}


def _torch_dtype(dt_enum: int) -> torch.dtype:
    if dt_enum not in _TORCH_DTYPES:
        raise UnsupportedOpError(f"DataType {dt_enum} has no torch dtype in the executor")
    return _TORCH_DTYPES[dt_enum]


def _inexact(dt: torch.dtype) -> torch.dtype:
    """jnp's float for an integer or bool dtype under enable_x64: float64
    for 64-bit integers, float32 below."""
    if dt.is_floating_point or dt.is_complex:
        return dt
    return torch.float64 if dt == torch.int64 else torch.float32


def _const_value(node) -> np.ndarray:
    tp = node.attr["value"].tensor
    try:
        return codec.to_ndarray(tp)
    except codec.CodecError as exc:
        # Consts may omit trailing repeated values (all-equal broadcast
        # trimming, legal on the TF side); codec validates counts strictly,
        # so repeat the last value out to the declared shape. ONLY for
        # dtypes whose repeated field we know — fabricating zeros for an
        # unhandled dtype would silently corrupt inference.
        dims = tuple(d.size for d in tp.tensor_shape.dim)
        np_dtype = _np_dtype(tp.dtype)
        field = {
            1: tp.float_val, 2: tp.double_val, 3: tp.int_val, 9: tp.int64_val,
            10: tp.bool_val,
        }.get(tp.dtype)
        vals = np.asarray(list(field) if field is not None else [], np_dtype)
        n = int(np.prod(dims)) if dims else 1
        if field is None or vals.size == 0 or vals.size > n:
            raise UnsupportedOpError(
                f"Const node {node.name!r}: cannot decode dtype "
                f"{tp.dtype} payload ({exc})"
            ) from exc
        if vals.size < n:
            vals = np.concatenate([vals, np.repeat(vals[-1], n - vals.size)])
        return vals.reshape(dims)


def _concrete(x, what: str) -> np.ndarray:
    """Require a static value (slice bounds, axes, shapes): reading a live
    tensor here would synchronize the host with the device."""
    if isinstance(x, torch.Tensor):
        raise UnsupportedOpError(
            f"{what} must be a graph constant (got a live device value); dynamic "
            "shapes/indices are outside the executor's scope"
        )
    try:
        return np.asarray(x)
    except Exception as exc:  # noqa: BLE001
        raise UnsupportedOpError(f"{what} must be a graph constant ({exc})") from exc


# ------------------------------------------------------------ array spaces
# The op table is written once over an array namespace `xp`: _HOST (numpy,
# the static folds) or a _Live (torch ops on one device). The reference's
# jax.nn activations (and DivNoNan, SquaredDifference, TopKV2, OneHot) run
# jnp whatever their inputs; here they are torch functions, which the host
# namespace applies to host tensors.


def _t_relu6(x):
    return torch.clamp(x, 0, 6)


def _t_gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _t_softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus


def _t_rsqrt(x):
    return 1.0 / torch.sqrt(x)


def _t_l2loss(x):
    return 0.5 * torch.sum(torch.square(x))


def _t_leaky_relu(x, alpha: float):
    return torch.where(x >= 0, x, alpha * x)  # jax.nn.leaky_relu


def _t_squared_difference(a, b):
    return torch.square(a - b)


def _t_div_no_nan(a, b):
    # jnp.where(b == 0, 0.0, a / jnp.where(b == 0, 1.0, b)): the weak 1.0
    # makes an integer divisor float64 under x64.
    zero = b == 0
    den = b if b.is_floating_point() else b.to(torch.float64)
    q = a / torch.where(zero, torch.ones_like(den), den)
    return torch.where(zero, torch.zeros_like(q), q)


def _t_top_k(x, k: int):
    # jax.lax.top_k: descending, the lower index first among ties. A stable
    # descending sort keeps that order (torch.topk on CUDA does not promise
    # it).
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def _t_one_hot(x, depth: int, axis: int, on, off):
    # jax.nn.one_hot: an out-of-range or negative index is an all-zero row.
    out_ndim = x.ndim + 1
    axis = axis + out_ndim if axis < 0 else axis
    shape = [1] * out_ndim
    shape[axis] = depth
    classes = torch.arange(depth, device=x.device).view(shape)
    hot = (x.unsqueeze(axis) == classes).to(on.dtype)
    return hot * on + (1 - hot) * off


_ACTIVATIONS = {
    "relu": torch.relu, "relu6": _t_relu6, "elu": F.elu, "selu": F.selu,
    "gelu": _t_gelu, "sigmoid": torch.sigmoid, "softplus": _t_softplus,
    "softsign": F.softsign, "erf": torch.special.erf, "rsqrt": _t_rsqrt,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "log_softmax": lambda x: torch.log_softmax(x, dim=-1), "l2loss": _t_l2loss,
}


def _host_tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True, order="C"))


def _host_via_torch(fn):
    """A torch function over host arrays: numpy in, numpy out."""
    def run(*args, **kwargs):
        out = fn(*(_host_tensor(a) if isinstance(a, (np.ndarray, np.generic)) else a
                   for a in args), **kwargs)
        if isinstance(out, tuple):
            return tuple(o.numpy() for o in out)
        return out.numpy()

    return run


class _Host:
    """The static namespace: numpy for the numpy-named functions (the
    reference's constant folds), the torch activations on host tensors."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def astype(x, dt_enum: int):
        if dt_enum == 14:  # numpy has no bf16: values rounded, float32 held
            return _host_tensor(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()
        return np.asarray(x).astype(_np_dtype(dt_enum))

    @staticmethod
    def getitem(x, idx):
        return np.asarray(x)[idx]

    @staticmethod
    def numel(x) -> int:
        return int(np.size(x))


for _name, _fn in _ACTIVATIONS.items():
    setattr(_Host, _name, staticmethod(_host_via_torch(_fn)))
_Host.leaky_relu = staticmethod(_host_via_torch(_t_leaky_relu))
_Host.squared_difference = staticmethod(_host_via_torch(_t_squared_difference))
_Host.div_no_nan = staticmethod(_host_via_torch(_t_div_no_nan))
_Host.top_k = staticmethod(_host_via_torch(_t_top_k))


def _host_one_hot(x, depth, axis, on, off):
    on_t, off_t = _host_tensor(on), _host_tensor(off)
    return _t_one_hot(_host_tensor(x), depth, axis, on_t, off_t).numpy()


_Host.one_hot = staticmethod(_host_one_hot)
_HOST = _Host()


def _bin(fn):
    return lambda self, a, b: fn(self.t(a), self.t(b))


def _un(fn, floating: bool = False):
    """A unary torch op; `floating` ops widen an integer input first, to
    jnp's float for it."""
    def run(self, x):
        x = self.t(x)
        if floating and not (x.is_floating_point() or x.is_complex()):
            x = x.to(_inexact(x.dtype))
        return fn(x)

    return run


def _red(name):
    return lambda self, x, axis, keepdims=False: self.reduce(name, x, axis, keepdims)


class _Live:
    """The live namespace: numpy-named functions as torch ops on `device`.
    Host operands move to the device through the library (graph constants
    once per device)."""

    def __init__(self, lib: _FunctionLibrary, device: torch.device):
        self.lib = lib
        self.device = device

    def t(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x
        return self.lib.to_live(x, self.device)

    add = _bin(torch.add)
    subtract = _bin(torch.sub)
    multiply = _bin(torch.mul)
    floor_divide = _bin(torch.floor_divide)
    mod = _bin(torch.remainder)  # floor mod (FloorMod)
    fmod = _bin(torch.fmod)  # truncated (Mod / TruncateMod)
    maximum = _bin(torch.maximum)
    minimum = _bin(torch.minimum)
    power = _bin(torch.pow)
    equal = _bin(torch.eq)
    not_equal = _bin(torch.ne)
    greater = _bin(torch.gt)
    greater_equal = _bin(torch.ge)
    less = _bin(torch.lt)
    less_equal = _bin(torch.le)
    logical_and = _bin(torch.logical_and)
    logical_or = _bin(torch.logical_or)
    matmul = _bin(torch.matmul)
    squared_difference = _bin(_t_squared_difference)
    div_no_nan = _bin(_t_div_no_nan)

    def divide(self, a, b):
        a, b = self.t(a), self.t(b)
        return torch.true_divide(a.to(_inexact(a.dtype)), b.to(_inexact(b.dtype)))

    tanh = _un(torch.tanh, True)
    exp = _un(torch.exp, True)
    log = _un(torch.log, True)
    log1p = _un(torch.log1p, True)
    sqrt = _un(torch.sqrt, True)
    square = _un(torch.square)
    abs = _un(torch.abs)
    negative = _un(torch.neg)
    sign = _un(torch.sign)
    floor = _un(torch.floor)
    ceil = _un(torch.ceil)
    round = _un(torch.round)  # half to even, as numpy's
    rint = _un(torch.round)
    zeros_like = _un(torch.zeros_like)
    ones_like = _un(torch.ones_like)
    logical_not = _un(torch.logical_not)

    sum = _red("sum")
    mean = _red("mean")
    max = _red("max")
    min = _red("min")
    prod = _red("prod")
    any = _red("any")
    all = _red("all")

    def reduce(self, name: str, x, axis, keepdims: bool):
        x = self.t(x)
        axes = sorted({int(a) % x.ndim for a in axis}) if x.ndim else []
        integral = not (x.is_floating_point() or x.is_complex())
        if name in ("sum", "prod"):
            dt = torch.int64 if integral else x.dtype  # jnp promotes integers
        elif name == "mean":
            dt = _inexact(x.dtype)
        elif name in ("any", "all"):
            dt = torch.bool
        else:
            dt = x.dtype
        x = x.to(dt)
        if not axes:
            return x  # an EMPTY axis list reduces nothing (TF and numpy agree)
        if name == "sum":
            return torch.sum(x, dim=axes, keepdim=keepdims)
        if name == "mean":
            return torch.mean(x, dim=axes, keepdim=keepdims)
        if name == "max":
            return torch.amax(x, dim=axes, keepdim=keepdims)
        if name == "min":
            return torch.amin(x, dim=axes, keepdim=keepdims)
        fn = {"prod": torch.prod, "any": torch.any, "all": torch.all}[name]
        for a in reversed(axes):  # highest first: the lower axes stay put
            x = fn(x, dim=a, keepdim=keepdims)
        return x

    def swapaxes(self, x, a: int, b: int):
        return torch.swapaxes(self.t(x), a, b)

    def reshape(self, x, shape):
        return torch.reshape(self.t(x), tuple(int(s) for s in shape))

    def concatenate(self, xs, axis: int):
        return torch.cat([self.t(x) for x in xs], dim=axis)

    def stack(self, xs, axis: int):
        return torch.stack([self.t(x) for x in xs], dim=axis)

    def split(self, x, num: int, axis: int):
        return list(torch.tensor_split(self.t(x), num, dim=axis))

    def squeeze(self, x, axis=None):
        x = self.t(x)
        if axis is None:
            return x.squeeze()
        for a in sorted({int(a) % x.ndim for a in axis}, reverse=True):
            x = x.squeeze(a)
        return x

    def expand_dims(self, x, axis: int):
        return torch.unsqueeze(self.t(x), axis)

    def transpose(self, x, perm):
        return self.t(x).permute(*perm)

    def take(self, x, idx, axis: int = 0):
        x, idx = self.t(x), self.t(idx)
        if idx.dtype not in (torch.int64, torch.int32):
            idx = idx.long()
        return x[(slice(None),) * (axis % x.ndim) + (idx,)]

    def take_along_axis(self, x, idx, axis: int):
        return torch.take_along_dim(self.t(x), self.t(idx).long(), dim=axis)

    def full(self, dims, value):
        return self.t(value).expand(tuple(int(d) for d in dims)).clone()

    def where(self, c, a, b):
        c = self.t(c)
        return torch.where(c if c.dtype == torch.bool else c.bool(), self.t(a), self.t(b))

    def clip(self, x, lo, hi):
        return torch.minimum(torch.maximum(self.t(x), self.t(lo)), self.t(hi))

    def einsum(self, eq: str, *xs):
        return torch.einsum(eq, *[self.t(x) for x in xs])

    def argmax(self, x, axis: int):
        return torch.argmax(self.t(x), dim=axis)

    def argmin(self, x, axis: int):
        return torch.argmin(self.t(x), dim=axis)

    def tile(self, x, reps):
        return torch.tile(self.t(x), tuple(int(r) for r in reps))

    def cumsum(self, x, axis: int):
        x = self.t(x)  # jnp.cumsum keeps the dtype (bool counts as int64)
        return torch.cumsum(x, dim=axis, dtype=torch.int64 if x.dtype == torch.bool else x.dtype)

    def astype(self, x, dt_enum: int):
        return self.t(x).to(_torch_dtype(dt_enum))

    def getitem(self, x, idx: tuple):
        """x[idx] with numpy's negative steps (a torch slice cannot step
        backwards): each such dim is flipped and sliced forwards."""
        x = self.t(x)
        if not any(isinstance(s, slice) and s.step is not None and s.step < 0 for s in idx):
            return x[idx]
        flips, fwd, d = [], [], 0
        for s in idx:
            if s is None:
                fwd.append(s)
                continue
            if isinstance(s, slice) and s.step is not None and s.step < 0:
                n = x.shape[d]
                start, stop, step = s.indices(n)
                picks = range(start, stop, step)
                flips.append(d)
                fwd.append(slice(n - 1 - picks[0], n - picks[-1], -step) if picks
                           else slice(0, 0))
            else:
                fwd.append(s)
            d += 1
        return x.flip(flips)[tuple(fwd)]

    @staticmethod
    def numel(x) -> int:
        return int(x.numel())

    def leaky_relu(self, x, alpha: float):
        return _t_leaky_relu(self.t(x), alpha)

    def top_k(self, x, k: int):
        return _t_top_k(self.t(x), k)

    def one_hot(self, x, depth: int, axis: int, on, off):
        return _t_one_hot(self.t(x), depth, axis, self.t(on), self.t(off))


for _name, _fn in _ACTIVATIONS.items():
    setattr(_Live, _name, _un(_fn, floating=_name not in ("relu", "relu6")))


def _live_device(values) -> torch.device | None:
    for v in values:
        if isinstance(v, torch.Tensor):
            return v.device
    return None


# --------------------------------------------------------------- op table
# Each entry: fn(node, inputs, xp) -> tuple of outputs. `inputs` are live
# tensors, host numpy values, or VarRef/TableRef. Single-output ops return
# a 1-tuple.


def _reduce(name):
    def run(node, inputs, xp):
        x, axes = inputs[0], _concrete(inputs[1], "reduction axes")
        keep = bool(_attr(node, "keep_dims").b) if _attr(node, "keep_dims") else False
        # TF: an EMPTY reduction_indices tensor is a no-op (numpy agrees
        # via axis=()); reduce-over-all is always an explicit Range.
        axes_t = tuple(int(a) for a in np.atleast_1d(axes))
        return (getattr(xp, name)(x, axis=axes_t, keepdims=keep),)

    return run


def _binop(name):
    return lambda node, inputs, xp: (getattr(xp, name)(inputs[0], inputs[1]),)


def _unop(name):
    return lambda node, inputs, xp: (getattr(xp, name)(inputs[0]),)


def _matmul(node, inputs, xp):
    a, b = inputs
    ta = bool(_attr(node, "transpose_a").b) if _attr(node, "transpose_a") else False
    tb = bool(_attr(node, "transpose_b").b) if _attr(node, "transpose_b") else False
    a = xp.swapaxes(a, 0, 1) if ta else a
    b = xp.swapaxes(b, 0, 1) if tb else b
    return (xp.matmul(a, b),)


def _batch_matmul(node, inputs, xp):
    a, b = inputs
    ta = bool(_attr(node, "adj_x").b) if _attr(node, "adj_x") else False
    tb = bool(_attr(node, "adj_y").b) if _attr(node, "adj_y") else False
    if ta:
        a = xp.swapaxes(a, -1, -2)
    if tb:
        b = xp.swapaxes(b, -1, -2)
    return (xp.matmul(a, b),)


def _bias_add(node, inputs, xp):
    x, b = inputs
    fmt = _attr(node, "data_format")
    if fmt is not None and fmt.s and fmt.s.decode() == "NCHW":
        shape = [1] * x.ndim
        shape[1] = b.shape[0]
        return (xp.add(x, xp.reshape(b, shape)),)
    return (xp.add(x, b),)


def _add_n(node, inputs, xp):
    out = inputs[0]
    for x in inputs[1:]:
        out = xp.add(out, x)
    return (out,)


def _cast(node, inputs, xp):
    return (xp.astype(inputs[0], node.attr["DstT"].type),)


def _reshape(node, inputs, xp):
    shape = [int(s) for s in _concrete(inputs[1], "Reshape shape")]
    return (xp.reshape(inputs[0], shape),)


def _concat_v2(node, inputs, xp):
    axis = int(_concrete(inputs[-1], "ConcatV2 axis"))
    return (xp.concatenate(inputs[:-1], axis=axis),)


def _pack(node, inputs, xp):
    axis = int(_attr(node, "axis").i) if _attr(node, "axis") else 0
    return (xp.stack(inputs, axis=axis),)


def _unpack(node, inputs, xp):
    axis = int(_attr(node, "axis").i) if _attr(node, "axis") else 0
    num = int(node.attr["num"].i)
    parts = xp.split(inputs[0], num, axis=axis)
    return tuple(xp.squeeze(p, axis=(axis,)) for p in parts)


def _expand_dims(node, inputs, xp):
    return (xp.expand_dims(inputs[0], int(_concrete(inputs[1], "ExpandDims axis"))),)


def _squeeze(node, inputs, xp):
    dims = _attr(node, "squeeze_dims")
    axes = tuple(int(i) for i in dims.list.i) if dims and dims.list.i else None
    return (xp.squeeze(inputs[0], axis=axes),)


def _transpose(node, inputs, xp):
    perm = [int(p) for p in _concrete(inputs[1], "Transpose perm")]
    return (xp.transpose(inputs[0], perm),)


def _gather_v2(node, inputs, xp):
    params, indices = inputs[0], inputs[1]
    axis = int(_concrete(inputs[2], "GatherV2 axis")) if len(inputs) > 2 else 0
    bd = _attr(node, "batch_dims")
    batch_dims = int(bd.i) if bd else 0
    if not batch_dims:
        return (xp.take(params, indices, axis=axis),)
    if batch_dims != axis:
        raise UnsupportedOpError(
            f"node {node.name!r}: GatherV2 with batch_dims={batch_dims} != "
            f"axis={axis} not supported"
        )
    if indices.ndim == params.ndim:
        return (xp.take_along_axis(params, indices, axis=axis),)
    if indices.ndim == axis + 1 and params.ndim == axis + 2:
        # The common batched embedding select: params [..B, N, D],
        # indices [..B, K] -> [..B, K, D]; take_along_axis broadcasts the
        # trailing unit dim over D.
        return (xp.take_along_axis(params, xp.expand_dims(indices, -1), axis=axis),)
    raise UnsupportedOpError(
        f"node {node.name!r}: GatherV2 batch_dims={batch_dims} with "
        f"params rank {params.ndim} / indices rank {indices.ndim} not supported"
    )


def _resource_gather(node, inputs, params, lib):
    ref, indices = inputs[0], inputs[1]
    if not isinstance(ref, VarRef):
        raise GraphExecError("ResourceGather expects a variable handle input")
    bd = _attr(node, "batch_dims")
    if bd and bd.i:
        raise UnsupportedOpError("ResourceGather with batch_dims not supported")
    table = params[ref.key]
    dev = _live_device((table, indices))
    xp = _HOST if dev is None else _Live(lib, dev)
    return (xp.take(table, indices, axis=0),)


def _strided_slice(node, inputs, xp):
    x = inputs[0]
    begin = [int(v) for v in _concrete(inputs[1], "StridedSlice begin")]
    end = [int(v) for v in _concrete(inputs[2], "StridedSlice end")]
    strides = [int(v) for v in _concrete(inputs[3], "StridedSlice strides")]
    bm = int(_attr(node, "begin_mask").i) if _attr(node, "begin_mask") else 0
    em = int(_attr(node, "end_mask").i) if _attr(node, "end_mask") else 0
    ellipsis = int(_attr(node, "ellipsis_mask").i) if _attr(node, "ellipsis_mask") else 0
    new_axis = int(_attr(node, "new_axis_mask").i) if _attr(node, "new_axis_mask") else 0
    shrink = int(_attr(node, "shrink_axis_mask").i) if _attr(node, "shrink_axis_mask") else 0

    ndim = x.ndim
    nspec = len(begin)
    # Dims of x consumed by the spec = every entry that is neither a
    # new-axis insertion nor the ellipsis itself; the ellipsis expands to
    # however many full slices are left over (possibly zero).
    consumed = sum(
        1 for d in range(nspec)
        if not (new_axis & (1 << d)) and not (ellipsis & (1 << d))
    )
    idx = []
    for spec_dim in range(nspec):
        bit = 1 << spec_dim
        if ellipsis & bit:
            idx.extend([slice(None)] * (ndim - consumed))
            continue
        if new_axis & bit:
            idx.append(None)
            continue
        if shrink & bit:
            idx.append(begin[spec_dim])
            continue
        b = None if bm & bit else begin[spec_dim]
        e = None if em & bit else end[spec_dim]
        s = strides[spec_dim]
        idx.append(slice(b, e, s))
    return (xp.getitem(x, tuple(idx)),)


def _slice(node, inputs, xp):
    x = inputs[0]
    begin = [int(v) for v in _concrete(inputs[1], "Slice begin")]
    size = [int(v) for v in _concrete(inputs[2], "Slice size")]
    idx = tuple(
        slice(b, None if s == -1 else b + s) for b, s in zip(begin, size)
    )
    return (xp.getitem(x, idx),)


def _shape(node, inputs, xp):
    out_type = _attr(node, "out_type")
    dt = _np_dtype(out_type.type) if out_type else np.int32
    return (np.asarray(tuple(inputs[0].shape), dt),)


def _fill(node, inputs, xp):
    dims = [int(d) for d in _concrete(inputs[0], "Fill dims")]
    return (xp.full(dims, inputs[1]),)


def _range(node, inputs, xp):
    s, l, d = (_concrete(v, "Range input") for v in inputs)
    return (np.arange(int(s), int(l), int(d), dtype=np.asarray(s).dtype),)


def _select(node, inputs, xp):
    return (xp.where(inputs[0], inputs[1], inputs[2]),)


def _clip(node, inputs, xp):
    return (xp.clip(inputs[0], inputs[1], inputs[2]),)


def _leaky_relu(node, inputs, xp):
    alpha = _attr(node, "alpha")
    return (xp.leaky_relu(inputs[0], alpha.f if alpha else 0.2),)


def _einsum(node, inputs, xp):
    eq = node.attr["equation"].s.decode()
    return (xp.einsum(eq, *inputs),)


def _arg_reduce(name):
    def run(node, inputs, xp):
        axis = int(_concrete(inputs[1], f"{name} axis")) if len(inputs) > 1 else 0
        ot = _attr(node, "output_type")
        fn = xp.argmax if name == "ArgMax" else xp.argmin
        return (xp.astype(fn(inputs[0], axis=axis), ot.type if ot else 9),)

    return run


def _tile(node, inputs, xp):
    reps = [int(r) for r in _concrete(inputs[1], "Tile multiples")]
    return (xp.tile(inputs[0], reps),)


def _top_k(node, inputs, xp):
    k = int(_concrete(inputs[1], "TopKV2 k")) if len(inputs) > 1 else int(node.attr["k"].i)
    return xp.top_k(inputs[0], k)


def _one_hot(node, inputs, xp):
    depth = int(_concrete(inputs[1], "OneHot depth"))
    ax = _attr(node, "axis")
    axis = int(ax.i) if ax else -1
    return (xp.one_hot(inputs[0], depth, axis, inputs[2], inputs[3]),)


def _identity(node, inputs, xp):
    return (inputs[0],)


_OPS = {
    "MatMul": _matmul,
    "BatchMatMul": _batch_matmul,
    "BatchMatMulV2": _batch_matmul,
    "BatchMatMulV3": _batch_matmul,
    "BiasAdd": _bias_add,
    "Add": _binop("add"),
    "AddV2": _binop("add"),
    "AddN": _add_n,
    "Sub": _binop("subtract"),
    "Mul": _binop("multiply"),
    "RealDiv": _binop("divide"),
    "Div": _binop("divide"),
    "DivNoNan": _binop("div_no_nan"),
    "FloorDiv": _binop("floor_divide"),
    "FloorMod": _binop("mod"),
    # TF's Mod/TruncateMod are C-style truncated remainder (the result takes
    # the DIVIDEND's sign); floor-mod is silently wrong for negative
    # operands. fmod is the truncating one.
    "Mod": _binop("fmod"),
    "TruncateMod": _binop("fmod"),
    "Maximum": _binop("maximum"),
    "Minimum": _binop("minimum"),
    "Pow": _binop("power"),
    "SquaredDifference": _binop("squared_difference"),
    "Relu": _unop("relu"),
    "Relu6": _unop("relu6"),
    "LeakyRelu": _leaky_relu,
    "Elu": _unop("elu"),
    "Selu": _unop("selu"),
    "Gelu": _unop("gelu"),
    "Sigmoid": _unop("sigmoid"),
    "Tanh": _unop("tanh"),
    "Softplus": _unop("softplus"),
    "Softsign": _unop("softsign"),
    "Exp": _unop("exp"),
    "Log": _unop("log"),
    "Log1p": _unop("log1p"),
    "Sqrt": _unop("sqrt"),
    "Rsqrt": _unop("rsqrt"),
    "Square": _unop("square"),
    "Abs": _unop("abs"),
    "Neg": _unop("negative"),
    "Sign": _unop("sign"),
    "Erf": _unop("erf"),
    "Floor": _unop("floor"),
    "Ceil": _unop("ceil"),
    "Round": _unop("round"),
    "Softmax": _unop("softmax"),
    "LogSoftmax": _unop("log_softmax"),
    "Cast": _cast,
    "Identity": _identity,
    "StopGradient": _identity,
    "PreventGradient": _identity,
    "CheckNumerics": _identity,
    "Snapshot": _identity,
    "EnsureShape": _identity,
    "IdentityN": lambda node, inputs, xp: tuple(inputs),
    "Reshape": _reshape,
    "ExpandDims": _expand_dims,
    "Squeeze": _squeeze,
    "Transpose": _transpose,
    "ConcatV2": _concat_v2,
    "Pack": _pack,
    "Unpack": _unpack,
    "StridedSlice": _strided_slice,
    "Slice": _slice,
    "Tile": _tile,
    "Fill": _fill,
    "ZerosLike": _unop("zeros_like"),
    "OnesLike": _unop("ones_like"),
    "Shape": _shape,
    "Rank": lambda node, inputs, xp: (np.asarray(inputs[0].ndim, np.int32),),
    "Size": lambda node, inputs, xp: (np.asarray(xp.numel(inputs[0]), np.int32),),
    "Range": _range,
    "GatherV2": _gather_v2,
    "Gather": lambda node, inputs, xp: (xp.take(inputs[0], inputs[1], axis=0),),
    "Sum": _reduce("sum"),
    "Mean": _reduce("mean"),
    "Max": _reduce("max"),
    "Min": _reduce("min"),
    "Prod": _reduce("prod"),
    "Any": _reduce("any"),
    "All": _reduce("all"),
    "ArgMax": _arg_reduce("ArgMax"),
    "ArgMin": _arg_reduce("ArgMin"),
    "Equal": _binop("equal"),
    "NotEqual": _binop("not_equal"),
    "Greater": _binop("greater"),
    "GreaterEqual": _binop("greater_equal"),
    "Less": _binop("less"),
    "LessEqual": _binop("less_equal"),
    "LogicalAnd": _binop("logical_and"),
    "LogicalOr": _binop("logical_or"),
    "LogicalNot": _unop("logical_not"),
    "Select": _select,
    "SelectV2": _select,
    "Where": lambda node, inputs, xp: (_fail_where(),),
    "ClipByValue": _clip,
    "Einsum": _einsum,
    "TopKV2": _top_k,
    "OneHot": _one_hot,
    "L2Loss": _unop("l2loss"),
    "Rint": _unop("rint"),
    "Cumsum": lambda node, inputs, xp: (
        xp.cumsum(inputs[0], axis=int(_concrete(inputs[1], "Cumsum axis"))),
    ),
}

_CALL_OPS = ("PartitionedCall", "StatefulPartitionedCall")


def _fail_where():
    raise UnsupportedOpError(
        "Where (dynamic-shape output) is outside the executor's scope"
    )


class _FunctionLibrary:
    def __init__(self, graph_def):
        self.functions = {f.signature.name: f for f in graph_def.library.function}
        # Each function body's nodes by name, built once: the node objects
        # stay alive as long as the library, so their ids key the caches.
        self.function_nodes = {name: {n.name: n for n in f.node_def}
                               for name, f in self.functions.items()}
        # table node name -> (sorted_keys, sorted_values) numpy arrays;
        # populated by _resolve_table_contents (GraphExecutor/graph_model).
        self.tables: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        # Import-time variable values (numpy), for resolving conditional
        # predicates concretely: the live variables are device tensors,
        # but a config-gated If's predicate is decided by frozen export-time
        # values — which is also what the value is on every request
        # (inference params never change within a servable version).
        # Populated by graph_model.
        self.const_params: dict[str, np.ndarray] = {}
        # Graph constants, decoded once: id(node) -> (node, array), the node
        # held so its id is never reused. The arrays' ids (and those of the
        # folds of constants alone, and of the table arrays) are
        # `const_ids`; only such arrays, alive as long as the library, may
        # key `_live_cache`, their device copies.
        self._consts: dict[int, tuple] = {}
        self._folds: dict[tuple, tuple] = {}
        self.const_ids: set[int] = set()
        self._live_cache: dict[tuple[int, str], tuple[np.ndarray, torch.Tensor]] = {}

    def const(self, node) -> np.ndarray:
        hit = self._consts.get(id(node))
        if hit is not None:
            return hit[1]
        arr = _const_value(node)
        arr.setflags(write=False)
        self._consts[id(node)] = (node, arr)
        self.const_ids.add(id(arr))
        return arr

    def fold(self, node, fn, inputs, xp) -> tuple:
        """A static node's outputs; memoized when every input is a graph
        constant (a fold of constants alone is one too)."""
        if not inputs or not all(isinstance(v, np.ndarray) and id(v) in self.const_ids
                                 for v in inputs):
            return fn(node, inputs, xp)
        key = (id(node),) + tuple(id(v) for v in inputs)
        hit = self._folds.get(key)
        if hit is not None:
            return hit[1]
        out = fn(node, inputs, xp)
        if all(isinstance(o, np.ndarray) for o in out):
            for o in out:
                self.const_ids.add(id(o))
            self._folds[key] = (node, out)
        return out

    def set_tables(self, tables: dict) -> None:
        self.tables = tables
        for k, v in tables.values():
            self.const_ids.update((id(k), id(v)))

    def to_live(self, x, device: torch.device) -> torch.Tensor:
        """A host value as a tensor on `device`: a 0-d one as a fill (no
        copy), a graph constant copied once per device, anything else
        through pinned memory without a host sync."""
        arr = np.asarray(x)
        key = (id(arr), str(device)) if id(arr) in self.const_ids else None
        if key is not None:
            hit = self._live_cache.get(key)
            if hit is not None:
                return hit[1]
        if arr.dtype not in _NP_TO_TORCH:
            raise UnsupportedOpError(f"a {arr.dtype} value cannot enter a live op")
        if arr.ndim == 0:
            t = torch.full((), arr.item(), dtype=_NP_TO_TORCH[arr.dtype], device=device)
        else:
            t = _host_tensor(arr)
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
        if key is not None:
            self._live_cache[key] = (arr, t)
        return t


def _concrete_ref(env, lib, ref: str, what: str):
    """Evaluate `ref` to a static value, re-walking the producing chain with
    numpy and import-time variable values when the value itself is live.
    Touching live data (a Placeholder, or a function arg with no static
    origin) raises UnsupportedOpError — that predicate genuinely is
    data-dependent."""
    val = env.tensor(ref)
    if not isinstance(val, torch.Tensor):
        return val
    parts = ref.split(":")
    head = parts[0]
    idx = int(parts[-1]) if len(parts) > 1 and parts[-1].isdigit() else 0
    node = env.nodes.get(head)
    if node is None:
        raise UnsupportedOpError(
            f"{what}: ref {ref!r} has no concrete origin in this scope"
        )
    if node.op in ("Placeholder", "PlaceholderWithDefault"):
        raise UnsupportedOpError(f"{what}: depends on live input {head!r}")
    if node.op == "ReadVariableOp":
        handle = _concrete_ref(env, lib, node.input[0], what)
        if isinstance(handle, VarRef) and handle.key in lib.const_params:
            return lib.const_params[handle.key]
        raise UnsupportedOpError(
            f"{what}: variable read has no import-time value"
        )
    fn = _OPS.get(node.op)
    if fn is None:
        raise UnsupportedOpError(
            f"{what}: cannot concretely evaluate op {node.op!r} ({head!r})"
        )
    inputs = [
        _concrete_ref(env, lib, i, what)
        for i in node.input
        if not i.startswith("^")
    ]
    try:
        return fn(node, inputs, _HOST)[idx]
    except (UnsupportedOpError, GraphExecError):
        raise
    except Exception as exc:  # noqa: BLE001
        raise UnsupportedOpError(
            f"{what}: concrete re-evaluation of {head!r} failed: {exc}"
        ) from exc


_TABLE_INIT_OPS = ("LookupTableImportV2", "LookupTableImport",
                   "InitializeTableV2", "InitializeTable")


def _resolve_table_contents(graph_def, lib: _FunctionLibrary) -> dict:
    """Statically extract every StaticHashTable's contents from the export.

    A `tf.lookup.StaticHashTable` serializes as a HashTableV2 node plus an
    initializer call chain ending in LookupTableImportV2(table, keys, values)
    where keys/values are main-graph Consts (tf 2.21 exports: the main graph
    holds `HashTableV2` + `StatefulPartitionedCall[table, Const, Const_1] ->
    __inference__initializer_N`). The serving signature never runs the init
    op, so contents are resolved statically: the table becomes a sorted
    key/value array pair, held on the device once, and lookups are
    searchsorted with no host callback.

    Only statically resolvable initializers are indexed; anything else
    (MutableHashTable, file-backed TextFileInitializer) stays out of the map
    and LookupTableFindV2 raises its ranked UnsupportedOpError.
    """
    tables: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    main_nodes = {n.name: n for n in graph_def.node}

    def resolve_main(ref: str):
        """('table', name) | ('const', array) | None for a main-graph ref."""
        node = main_nodes.get(ref.partition(":")[0])
        if node is None:
            return None
        if node.op in ("HashTableV2", "HashTable"):
            return ("table", node.name)
        if node.op == "Const":
            try:
                return ("const", _const_value(node))
            except Exception:  # noqa: BLE001 — undecodable (e.g. string) const
                return None
        if node.op == "Identity":
            return resolve_main(node.input[0])
        return None

    def record(table, keys, values):
        if table is None or keys is None or values is None:
            return
        if table[0] != "table" or keys[0] != "const" or values[0] != "const":
            return
        k, v = np.asarray(keys[1]).ravel(), np.asarray(values[1]).ravel()
        if k.dtype.kind not in "iu" or v.dtype.kind not in "iufb" or k.size != v.size:
            # String/float keys or string/object VALUES: out of scope —
            # staying unresolved turns the serve-time find into the ranked
            # UnsupportedOpError instead of a dtype crash.
            return
        order = np.argsort(k, kind="stable")
        tables[table[1]] = (k[order], v[order])

    def scan(nodes, resolve, depth):
        if depth > 4:
            return
        for node in nodes:
            if node.op in _TABLE_INIT_OPS and len(node.input) >= 3:
                record(resolve(node.input[0]), resolve(node.input[1]),
                       resolve(node.input[2]))
            elif node.op in _CALL_OPS or node.op in lib.functions:
                fname = (
                    node.attr["f"].func.name
                    if node.op in _CALL_OPS
                    else node.op
                )
                fdef = lib.functions.get(fname)
                if fdef is None:
                    continue
                data_inputs = [i for i in node.input if not i.startswith("^")]
                bindings = {
                    a.name: resolve(ref)
                    for a, ref in zip(fdef.signature.input_arg, data_inputs)
                }

                def resolve_fn(ref, _b=bindings, _f=fdef):
                    head = ref.partition(":")[0]
                    if head in _b:
                        return _b[head]
                    fnode = next(
                        (n for n in _f.node_def if n.name == head), None
                    )
                    if fnode is None:
                        return None
                    if fnode.op == "Const":
                        try:
                            return ("const", _const_value(fnode))
                        except Exception:  # noqa: BLE001
                            return None
                    if fnode.op == "Identity":
                        return resolve_fn(fnode.input[0], _b, _f)
                    return None

                scan(fdef.node_def, resolve_fn, depth + 1)

    scan(graph_def.node, resolve_main, 0)
    return tables


def _table_entry(lib, ref, node):
    if not isinstance(ref, TableRef):
        raise GraphExecError(f"{node.name}: lookup on a non-table input")
    entry = lib.tables.get(ref.key)
    if entry is None:
        raise UnsupportedOpError(
            f"{node.name}: hash table {ref.key!r} has no statically "
            "resolvable contents — mutable tables, file-backed initializers "
            "and string-keyed tables are outside the executor's scope "
            "(supported: StaticHashTable over integer keys with "
            "KeyValueTensorInitializer consts)"
        )
    return entry


def _lookup_find(node, inputs, lib, xp):
    """LookupTableFindV2 as a static sorted-array probe: searchsorted +
    equality select (torch.searchsorted over the keys held on the device;
    no host callback)."""
    sk, sv = _table_entry(lib, inputs[0], node)
    keys, default = inputs[1], inputs[2]
    if xp is _HOST:
        keys = np.asarray(keys)
        dflt = np.asarray(default, sv.dtype)
        if sk.size == 0:
            return (np.full(keys.shape, dflt, dtype=sv.dtype),)
        idx = np.clip(np.searchsorted(sk, keys), 0, sk.size - 1)
        return (np.where(sk[idx] == keys, sv[idx], dflt),)
    keys = xp.t(keys)
    dflt = xp.t(default).to(_NP_TO_TORCH[sv.dtype])
    if sk.size == 0:
        return (dflt.expand(keys.shape).clone(),)
    sk_t, sv_t = xp.t(sk), xp.t(sv)
    keys = keys.to(sk_t.dtype)
    idx = torch.searchsorted(sk_t, keys.contiguous()).clamp_(0, sk.size - 1)
    return (torch.where(sk_t[idx] == keys, sv_t[idx], dflt),)


class _GraphEval:
    """Evaluates the main GraphDef. Tensor refs: 'node', 'node:k', '^ctrl'."""

    def __init__(self, nodes, lib, params, feeds):
        self.nodes = nodes
        self.lib = lib
        self.params = params
        self.feeds = feeds  # placeholder node name -> value
        self.memo: dict[str, tuple] = {}

    def tensor(self, ref: str):
        if ref.startswith("^"):
            return None
        name, _, idx = ref.partition(":")
        return self.node_outputs(name)[int(idx) if idx else 0]

    def node_outputs(self, name: str) -> tuple:
        if name in self.memo:
            return self.memo[name]
        node = self.nodes.get(name)
        if node is None:
            raise GraphExecError(f"graph references unknown node {name!r}")
        out = _eval_node(node, self, self.lib, self.params)
        self.memo[name] = out
        return out


class _FuncEval:
    """Evaluates a FunctionDef body. Tensor refs: 'arg' (function input) or
    'node:out_arg_name:k' (flat index k — valid for single-tensor output
    args, which covers every op in the table)."""

    def __init__(self, fdef, args, lib, params):
        self.fdef = fdef
        self.lib = lib
        self.params = params
        self.nodes = lib.function_nodes[fdef.signature.name]
        self.args = {
            a.name: v for a, v in zip(fdef.signature.input_arg, args)
        }
        self.memo: dict[str, tuple] = {}

    def tensor(self, ref: str):
        if ref.startswith("^"):
            return None
        parts = ref.split(":")
        if len(parts) == 1:
            if parts[0] in self.args:
                return self.args[parts[0]]
            # A nullary node referenced bare (Const inside a function).
            return self.node_outputs(parts[0])[0]
        if len(parts) == 2:
            # 'arg:0' style for function inputs.
            if parts[0] in self.args:
                return self.args[parts[0]]
            return self.node_outputs(parts[0])[int(parts[1])]
        name, _out_arg, idx = parts[0], parts[1], parts[2]
        return self.node_outputs(name)[int(idx)]

    def node_outputs(self, name: str) -> tuple:
        if name in self.memo:
            return self.memo[name]
        node = self.nodes.get(name)
        if node is None:
            raise GraphExecError(
                f"function {self.fdef.signature.name!r} references unknown node {name!r}"
            )
        out = _eval_node(node, self, self.lib, self.params)
        self.memo[name] = out
        return out

    def results(self) -> tuple:
        return tuple(
            self.tensor(self.fdef.ret[o.name]) for o in self.fdef.signature.output_arg
        )


def _namespace(lib, inputs):
    dev = _live_device(inputs)
    return _HOST if dev is None else _Live(lib, dev)


def _eval_node(node, env, lib, params) -> tuple:
    op = node.op
    if op == "Placeholder" or op == "PlaceholderWithDefault":
        feeds = getattr(env, "feeds", None)
        if feeds is not None and node.name in feeds:
            return (feeds[node.name],)
        if op == "PlaceholderWithDefault":
            return (env.tensor(node.input[0]),)
        raise GraphExecError(f"placeholder {node.name!r} was not fed")
    if op == "Const":
        return (lib.const(node),)
    if op == "NoOp":
        return ()
    if op in ("VarHandleOp", "VariableV2", "VarIsInitializedOp"):
        if op == "VarIsInitializedOp":
            return (np.asarray(True),)
        shared = _attr(node, "shared_name")
        key = shared.s.decode() if shared is not None and shared.s else node.name
        if key not in params and node.name in params:
            key = node.name
        if op == "VariableV2":
            # TF1 ref-variables YIELD the tensor value wherever referenced
            # (MatMul/Gather consume the ref directly; there is no
            # ReadVariableOp in a TF1 graph) — only TF2 resource handles
            # (VarHandleOp) flow as opaque VarRefs to their read sites.
            if key not in params:
                raise GraphExecError(
                    f"{node.name}: TF1 variable {key!r} not found in extracted "
                    f"checkpoint values (have {sorted(params)[:8]}...)"
                )
            return (params[key],)
        return (VarRef(key),)
    if op == "ReadVariableOp":
        ref = env.tensor(node.input[0])
        if not isinstance(ref, VarRef):
            raise GraphExecError(f"{node.name}: ReadVariableOp on a non-handle input")
        if ref.key not in params:
            raise GraphExecError(
                f"{node.name}: variable {ref.key!r} not found in extracted "
                f"checkpoint values (have {sorted(params)[:8]}...)"
            )
        return (params[ref.key],)
    if op == "ResourceGather":
        inputs = [env.tensor(i) for i in node.input if not i.startswith("^")]
        return _resource_gather(node, inputs, params, lib)
    if op in ("HashTableV2", "HashTable"):
        return (TableRef(node.name),)
    if op in ("LookupTableFindV2", "LookupTableFind"):
        inputs = [env.tensor(i) for i in node.input if not i.startswith("^")]
        return _lookup_find(node, inputs, lib, _namespace(lib, inputs))
    if op in ("LookupTableSizeV2", "LookupTableSize"):
        ref = env.tensor(node.input[0])
        sk, _sv = _table_entry(lib, ref, node)
        return (np.asarray(sk.size, np.int64),)
    if op in _TABLE_INIT_OPS:
        # Contents were resolved statically (_resolve_table_contents); the
        # init op itself is a no-op if an init path is ever walked.
        return ()
    if op in ("AssignVariableOp", "AssignAddVariableOp"):
        raise UnsupportedOpError(
            f"{node.name}: stateful variable mutation ({op}) in a serving "
            "graph is outside the executor's scope"
        )
    if op in ("If", "StatelessIf"):
        # Constant-predicate conditionals: the chosen branch is inlined.
        # Serving graphs gate preprocessing on captured config constants/
        # variables; their reads are live tensors, so the predicate is
        # re-evaluated on the host against import-time values
        # (_concrete_ref) — never read back from the device. A predicate
        # that depends on live input stays out of scope.
        try:
            cond = _concrete_ref(
                env, lib, node.input[0], f"node {node.name!r} ({op}) predicate"
            )
        except UnsupportedOpError as exc:
            raise UnsupportedOpError(
                f"node {node.name!r}: {op} with a data-dependent predicate "
                f"is outside the executor's scope ({exc})"
            ) from exc
        branch = "then_branch" if bool(np.asarray(cond)) else "else_branch"
        fname = node.attr[branch].func.name
        args = [env.tensor(i) for i in node.input[1:] if not i.startswith("^")]
        return _invoke_function(fname, node, args, lib, params, role=branch)
    if op in ("Case", "StatelessCase"):
        try:
            idx = _concrete_ref(
                env, lib, node.input[0], f"node {node.name!r} ({op}) index"
            )
        except UnsupportedOpError as exc:
            raise UnsupportedOpError(
                f"node {node.name!r}: {op} with a data-dependent branch "
                f"index is outside the executor's scope ({exc})"
            ) from exc
        branches = node.attr["branches"].list.func
        if not branches:
            raise GraphExecError(f"{node.name}: Case with no branches")
        i = int(np.asarray(idx))
        # TF semantics: ANY out-of-range index (negative included) runs
        # the LAST branch.
        if i < 0 or i >= len(branches):
            i = len(branches) - 1
        args = [env.tensor(r) for r in node.input[1:] if not r.startswith("^")]
        return _invoke_function(
            branches[i].name, node, args, lib, params, role=f"branch {i}"
        )
    if op in _CALL_OPS:
        fname = node.attr["f"].func.name
        return _call_function(fname, node, env, lib, params)
    if op in lib.functions:
        return _call_function(op, node, env, lib, params)
    fn = _OPS.get(op)
    if fn is None:
        raise UnsupportedOpError(
            f"node {node.name!r}: op {op!r} is outside the executor's scope "
            "(see graph_exec.py module docstring for the supported set)"
        )
    inputs = [env.tensor(i) for i in node.input if not i.startswith("^")]
    # A node with no live input folds on the host with numpy — exactly TF's
    # own constant folding — so shape-arithmetic subgraphs (tf.shape ->
    # Pack -> Reshape) stay host values; a node that reads a live tensor
    # runs as torch ops on its device.
    xp = _namespace(lib, inputs)
    try:
        if xp is _HOST:
            return lib.fold(node, fn, inputs, xp)
        return fn(node, inputs, xp)
    except (UnsupportedOpError, GraphExecError):
        raise
    except Exception as exc:  # name the node: anonymous shape errors are undebuggable
        raise GraphExecError(
            f"node {node.name!r} (op {op}): {type(exc).__name__}: {exc}"
        ) from exc


def _invoke_function(fname, node, args, lib, params, role="function") -> tuple:
    """Arity-checked FunctionDef invocation — ONE implementation shared by
    direct calls, If branches, and Case branches, so a mismatched call
    always reports 'takes N args, got M' rather than a downstream
    unknown-node error."""
    fdef = lib.functions.get(fname)
    if fdef is None:
        raise GraphExecError(f"{node.name}: unknown {role} {fname!r}")
    want = len(fdef.signature.input_arg)
    if len(args) != want:
        raise GraphExecError(
            f"{node.name}: {role} {fname!r} takes {want} args, got {len(args)}"
        )
    return _FuncEval(fdef, args, lib, params).results()


def _call_function(fname, node, env, lib, params) -> tuple:
    args = [env.tensor(i) for i in node.input if not i.startswith("^")]
    return _invoke_function(fname, node, args, lib, params)


# ------------------------------------------------------------- public API


class GraphExecutor:
    """Callable built from a MetaGraphDef signature: feeds placeholders,
    walks the graph, returns the signature's outputs keyed by alias, as
    tensors on the live device (the feeds', else the variables')."""

    def __init__(self, meta_graph, signature_name: str = "serving_default"):
        if signature_name not in meta_graph.signature_def:
            raise GraphExecError(
                f"signature {signature_name!r} not in export; have "
                f"{sorted(meta_graph.signature_def)}"
            )
        sig = meta_graph.signature_def[signature_name]
        self.graph_def = meta_graph.graph_def
        self.nodes = {n.name: n for n in self.graph_def.node}
        self.lib = _FunctionLibrary(self.graph_def)
        self.lib.set_tables(_resolve_table_contents(self.graph_def, self.lib))
        if self.lib.tables:
            log.info(
                "resolved %d static hash table(s): %s",
                len(self.lib.tables),
                {k: v[0].size for k, v in self.lib.tables.items()},
            )
        # alias -> (node_name, output_index)
        def split(tname):
            name, _, idx = tname.partition(":")
            return name, int(idx) if idx else 0

        self.input_nodes = {a: split(i.name)[0] for a, i in sig.inputs.items()}
        self.outputs = {a: split(i.name) for a, i in sig.outputs.items()}
        self.input_dtypes = {a: i.dtype for a, i in sig.inputs.items()}

    def needs_x64(self, variables) -> bool:
        wide = (9, 2)  # DT_INT64, DT_DOUBLE
        if any(dt in wide for dt in self.input_dtypes.values()):
            return True
        if any(np.asarray(v).dtype in (np.int64, np.float64) for v in variables.values()):
            return True
        # Baked hash-table constants count too: a graph whose ONLY int64
        # tensors are table keys (an int32 input Cast to int64 before the
        # lookup) carries catalog ids past 2^31 all the same.
        return any(
            k.dtype in (np.int64, np.float64) or v.dtype in (np.int64, np.float64)
            for k, v in self.lib.tables.values()
        )

    def __call__(self, params: dict, batch: dict) -> dict:
        dev = _live_device(batch.values()) or _live_device(params.values()) \
            or torch.device("cpu")
        feeds = {}
        for alias, node_name in self.input_nodes.items():
            if alias in batch:
                v = batch[alias]
                # A feed is live whatever the caller handed in, so a
                # predicate on it is data-dependent here as in the
                # reference's jitted serving path.
                feeds[node_name] = v if isinstance(v, torch.Tensor) \
                    else _host_tensor(v).to(dev)
        ev = _GraphEval(self.nodes, self.lib, params, feeds)
        out = {}
        for alias, (name, idx) in self.outputs.items():
            v = ev.node_outputs(name)[idx]
            out[alias] = v if isinstance(v, torch.Tensor) else _host_tensor(v).to(dev)
        return out


def graph_model(
    meta_graph,
    variables: dict[str, np.ndarray],
    signature_name: str = "serving_default",
    name: str = "imported",
    device=None,
) -> tuple[Model, dict]:
    """Build a servable Model executing the export's own graph.

    Returns (model, params). params is flat {variable_key: tensor} on
    `device` (default "cuda"); a non-numeric variable stays a host array."""
    dev = resolve_device(device)
    ex = GraphExecutor(meta_graph, signature_name)
    # Import-time values back the concrete predicate resolution for
    # config-gated conditionals (see _FunctionLibrary.const_params).
    ex.lib.const_params = {k: np.asarray(v) for k, v in variables.items()}
    sig = meta_graph.signature_def[signature_name]

    # num_fields from the first 2-D int input when present (diagnostics and
    # the Example decode path); fall back to the default.
    num_fields = 0
    for info in sig.inputs.values():
        dims = [d.size for d in info.tensor_shape.dim]
        if len(dims) == 2 and dims[1] > 0:
            num_fields = int(dims[1])
            break
    config = ModelConfig(name=name, num_fields=num_fields or 43)

    def init(*args, **kwargs):
        raise GraphExecError(
            "graph-executor models carry imported variables; init() is not "
            "available (no architecture to initialize)"
        )

    model = Model(
        config=config,
        init=init,
        apply=ex,
        wts_in_compute_dtype=False,
        folds_ids_on_host=False,
        needs_x64=ex.needs_x64(variables),
    )
    params = {
        k: _host_tensor(v).to(dev) if np.asarray(v).dtype in _NP_TO_TORCH else np.asarray(v)
        for k, v in variables.items()
    }
    return model, params
