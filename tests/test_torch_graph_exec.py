"""The port's GraphDef executor (interop/graph_exec.py) held to the JAX
package's (tests/test_graph_exec.py's cases): every entry of the op table on
the same seeded inputs, as live tensors (the reference's jitted jnp path
under enable_x64) and as graph constants (both packages' numpy folds),
values and dtypes; the named failures; and genuine TensorFlow exports —
field attention, a static hash table, a constant-predicate cond, a custom
signature name, a Keras model and a TF1 graph — against TF's own forward
and the JAX executor, one of them over the port's gRPC server with ids past
2^31. Each TensorFlow export is built once per module (two TF processes);
the graph variables of the TF2 exports are extracted in the building
process too, and the importer's own extraction subprocess runs once per
script flavour (TF2 signature graph, TF1 checkpoint)."""

import json
import pathlib
import shutil
import subprocess
import sys

import grpc
import jax
import numpy as np
import pytest
import torch

from distributed_tf_serving_tpu.interop import graph_exec as jge
from distributed_tf_serving_tpu.interop import savedmodel as jsm
from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.proto import tf_meta_graph_pb2 as jax_mg
from distributed_tf_serving_tpu.utils.compat import enable_x64
from distributed_tf_serving_tpu_torch import codec
from distributed_tf_serving_tpu_torch.interop import graph_exec as ge
from distributed_tf_serving_tpu_torch.interop import savedmodel as sm
from distributed_tf_serving_tpu_torch.models import ModelConfig, ServableRegistry
from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub
from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
from distributed_tf_serving_tpu_torch.proto import tf_meta_graph_pb2 as mg
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher
from distributed_tf_serving_tpu_torch.serving.server import create_server
from distributed_tf_serving_tpu_torch.serving.service import PredictionServiceImpl

# ------------------------------------------------------------ per-op cases

_R = np.random.RandomState(0)
F32 = _R.randn(3, 4).astype(np.float32)
G32 = _R.randn(3, 4).astype(np.float32)
POS = (_R.rand(3, 4) + 0.1).astype(np.float32)
HALVES = np.array([[0.5, 1.5, 2.5, -0.5], [-1.5, 3.49, -2.5, 0.0]], np.float32)
IA = np.array([[7, -7, 7, -7], [5, -3, 0, 9], [1, 2, 3, 4]], np.int64)
IB = np.array([[3, 3, -3, -3], [2, 2, 5, -4], [1, 1, 2, 3]], np.int64)
I32 = IA.astype(np.int32)
BA = np.array([[True, False, True, False]] * 3)
BB = np.array([[True, True, False, False]] * 3)
TIES = np.array([[1, 3, 3, 2, 3], [0, 0, 0, 0, 0], [5, -1, 5, 7, 7]], np.float32)
ZB = np.where(np.abs(G32) < 0.5, 0.0, G32).astype(np.float32)


def c(x, dtype=None):
    """A static operand (a graph Const)."""
    return ("const", np.asarray(x, dtype))


def attrs(**kw):
    """Node attributes: bool / int / float / bytes / list of ints /
    ('type', DataType)."""
    def apply(node):
        for k, v in kw.items():
            if isinstance(v, bool):
                node.attr[k].b = v
            elif isinstance(v, int):
                node.attr[k].i = v
            elif isinstance(v, float):
                node.attr[k].f = v
            elif isinstance(v, bytes):
                node.attr[k].s = v
            elif isinstance(v, list):
                node.attr[k].list.i.extend(v)
            elif isinstance(v, tuple) and v[0] == "type":
                node.attr[k].type = v[1]
    return apply


def _op_cases():
    bins = [("Add", F32, G32), ("AddV2", F32, G32), ("Sub", F32, G32), ("Mul", F32, G32),
            ("RealDiv", F32, POS), ("Div", F32, POS), ("Maximum", F32, G32),
            ("Minimum", F32, G32), ("Pow", POS, G32), ("SquaredDifference", F32, G32),
            ("DivNoNan", F32, ZB), ("FloorDiv", F32, POS), ("FloorMod", F32, POS),
            ("Equal", F32, np.where(BA, F32, G32)), ("NotEqual", F32, np.where(BA, F32, G32)),
            ("Greater", F32, G32), ("GreaterEqual", F32, np.where(BA, F32, G32)),
            ("Less", F32, G32), ("LessEqual", F32, np.where(BA, F32, G32)),
            ("LogicalAnd", BA, BB), ("LogicalOr", BA, BB)]
    cases = [(f"{op}", op, [x, y], None, 1) for op, x, y in bins]
    # Integer arithmetic, negative operands included: Mod/TruncateMod are
    # truncated (C), FloorMod floored (Python); integer divides widen.
    for op in ("Add", "Sub", "Mul", "FloorDiv", "FloorMod", "Mod", "TruncateMod",
               "Maximum", "Minimum", "Div", "RealDiv", "DivNoNan"):
        cases.append((f"{op}-int64", op, [IA, IB], None, 1))
    for op in ("FloorMod", "Mod", "Div"):
        cases.append((f"{op}-int32", op, [I32, IB.astype(np.int32)], None, 1))
    cases.append(("Mod-float", "Mod", [F32 * 5, G32], None, 1))
    cases.append(("Equal-int64", "Equal", [IA, np.where(BA, IA, IB)], None, 1))
    unary = [("Relu", F32), ("Relu6", F32 * 5), ("Elu", F32), ("Selu", F32), ("Gelu", F32),
             ("Sigmoid", F32), ("Tanh", F32), ("Softplus", F32 * 10), ("Softsign", F32),
             ("Exp", F32), ("Log", POS), ("Log1p", POS), ("Sqrt", POS), ("Rsqrt", POS),
             ("Square", F32), ("Abs", F32), ("Neg", F32), ("Sign", F32), ("Erf", F32),
             ("Floor", F32 * 3), ("Ceil", F32 * 3), ("Round", HALVES), ("Rint", HALVES),
             ("Softmax", F32), ("LogSoftmax", F32), ("L2Loss", F32), ("ZerosLike", F32),
             ("OnesLike", IA), ("LogicalNot", BA), ("Identity", F32), ("StopGradient", F32),
             ("PreventGradient", F32), ("CheckNumerics", F32), ("Snapshot", F32),
             ("EnsureShape", F32), ("Square-int64", IA), ("Abs-int64", IA), ("Neg-int64", IA),
             ("Sign-int64", IA)]
    for name, x in unary:
        cases.append((name, name.split("-")[0], [x], None, 1))
    cases.append(("Gelu-exact-attr", "Gelu", [F32], attrs(approximate=False), 1))
    cases += [
        ("LeakyRelu", "LeakyRelu", [F32], attrs(alpha=0.3), 1),
        ("LeakyRelu-default", "LeakyRelu", [F32], None, 1),
        ("MatMul", "MatMul", [F32, G32.T.copy()], None, 1),
        ("MatMul-transpose", "MatMul", [F32.T.copy(), G32], attrs(transpose_a=True,
                                                                 transpose_b=True), 1),
        ("BatchMatMul", "BatchMatMul", [np.stack([F32, G32]), np.stack([G32.T, F32.T])], None, 1),
        ("BatchMatMulV2", "BatchMatMulV2", [np.stack([F32, G32]), np.stack([F32, G32])],
         attrs(adj_y=True), 1),
        ("BatchMatMulV3", "BatchMatMulV3", [np.stack([F32.T, G32.T]), np.stack([F32, G32])],
         attrs(adj_x=True, adj_y=True), 1),
        ("BiasAdd", "BiasAdd", [F32, G32[0]], None, 1),
        ("BiasAdd-NCHW", "BiasAdd", [np.stack([F32, G32]).reshape(2, 3, 2, 2), G32[0, :3].copy()],
         attrs(data_format=b"NCHW"), 1),
        ("AddN", "AddN", [F32, G32, POS], None, 1),
        ("Cast-f32-int32", "Cast", [F32 * 10], attrs(DstT=("type", 3)), 1),
        ("Cast-int64-f32", "Cast", [IA], attrs(DstT=("type", 1)), 1),
        ("Cast-f32-bool", "Cast", [ZB], attrs(DstT=("type", 10)), 1),
        ("Cast-bool-int64", "Cast", [BA], attrs(DstT=("type", 9)), 1),
        ("IdentityN", "IdentityN", [F32, IA], None, 2),
        ("Reshape", "Reshape", [F32, c([2, -1], np.int32)], None, 1),
        ("ExpandDims", "ExpandDims", [F32, c(-1, np.int32)], None, 1),
        ("Squeeze", "Squeeze", [F32.reshape(1, 3, 1, 4)], None, 1),
        ("Squeeze-dims", "Squeeze", [F32.reshape(1, 3, 1, 4)], attrs(squeeze_dims=[2]), 1),
        ("Transpose", "Transpose", [np.stack([F32, G32]), c([2, 0, 1], np.int32)], None, 1),
        ("ConcatV2", "ConcatV2", [F32, G32, POS, c(1, np.int32)], None, 1),
        ("Pack", "Pack", [F32, G32], attrs(axis=1), 1),
        ("Unpack", "Unpack", [F32], attrs(num=3), 3),
        ("Unpack-axis1", "Unpack", [F32], attrs(num=4, axis=1), 4),
        ("StridedSlice", "StridedSlice", [F32, c([0, 1], np.int32), c([2, 4], np.int32),
                                          c([1, 2], np.int32)], None, 1),
        ("StridedSlice-reverse", "StridedSlice",
         [F32, c([0, -1], np.int32), c([0, 0], np.int32), c([1, -1], np.int32)],
         attrs(begin_mask=1, end_mask=3), 1),
        ("StridedSlice-reverse-step2", "StridedSlice",
         [F32, c([-1, 3], np.int32), c([0, 0], np.int32), c([-2, -2], np.int32)],
         attrs(end_mask=3), 1),
        ("StridedSlice-shrink-newaxis", "StridedSlice",
         [np.stack([F32, G32]), c([0, 0, 1], np.int32), c([0, 0, 2], np.int32),
          c([1, 1, 1], np.int32)], attrs(new_axis_mask=1, shrink_axis_mask=4, ellipsis_mask=2),
         1),
        ("Slice", "Slice", [F32, c([1, 1], np.int32), c([-1, 2], np.int32)], None, 1),
        ("Tile", "Tile", [F32, c([2, 1], np.int32)], None, 1),
        ("Fill", "Fill", [c([2, 3], np.int32), np.asarray(2.5, np.float32)], None, 1),
        ("Shape", "Shape", [F32], None, 1),
        ("Shape-int64", "Shape", [F32], attrs(out_type=("type", 9)), 1),
        ("Rank", "Rank", [F32], None, 1),
        ("Size", "Size", [F32], None, 1),
        ("Range", "Range", [c(1, np.int32), c(11, np.int32), c(3, np.int32)], None, 1),
        ("GatherV2", "GatherV2", [G32, IA[:2, :3] % 3, c(0, np.int32)], None, 1),
        ("GatherV2-axis1", "GatherV2", [G32, IA[:2, :3] % 4, c(1, np.int32)], None, 1),
        ("GatherV2-negative", "GatherV2", [G32, np.array([-1, 0, -3], np.int64),
                                           c(0, np.int32)], None, 1),
        ("GatherV2-batch-dims", "GatherV2",
         [np.stack([F32, G32]), (IA[:2] % 3).copy(), c(1, np.int32)], attrs(batch_dims=1), 1),
        ("Gather", "Gather", [G32, IA[:2, :3] % 3], None, 1),
        ("ArgMax", "ArgMax", [TIES, c(1, np.int32)], None, 1),
        ("ArgMax-int32", "ArgMax", [TIES, c(0, np.int32)], attrs(output_type=("type", 3)), 1),
        ("ArgMin", "ArgMin", [TIES, c(1, np.int32)], None, 1),
        ("Select", "Select", [BA, F32, G32], None, 1),
        ("SelectV2", "SelectV2", [BA[0], F32, G32], None, 1),
        ("ClipByValue", "ClipByValue", [F32, c(-0.5, np.float32), c(0.7, np.float32)], None, 1),
        ("Einsum", "Einsum", [F32, G32.T.copy()], attrs(equation=b"ij,jk->ik"), 1),
        ("Einsum-bilinear", "Einsum", [F32, POS[:, :4].T @ POS[:, :4], F32],
         attrs(equation=b"nd,de,ne->n"), 1),
        ("TopKV2-ties", "TopKV2", [TIES, c(3, np.int32)], None, 2),
        ("OneHot", "OneHot", [np.array([[0, 2, 5], [-1, 1, 3]], np.int64), c(4, np.int32),
                              c(1.5, np.float32), c(-0.5, np.float32)], None, 1),
        ("OneHot-axis0", "OneHot", [np.array([0, 2, 3], np.int32), c(3, np.int32),
                                    c(1, np.int64), c(0, np.int64)], attrs(axis=0), 1),
        ("Cumsum", "Cumsum", [F32, c(1, np.int32)], None, 1),
        ("Cumsum-int32", "Cumsum", [I32, c(0, np.int32)], None, 1),
        ("Cumsum-exclusive-ignored", "Cumsum", [F32, c(1, np.int32)],
         attrs(exclusive=True, reverse=True), 1),
    ]
    for red in ("Sum", "Mean", "Max", "Min", "Prod"):
        cases.append((red, red, [F32, c([1], np.int32)], None, 1))
        cases.append((f"{red}-keep", red, [F32, c([0, 1], np.int32)], attrs(keep_dims=True), 1))
        cases.append((f"{red}-int32", red, [I32, c(0, np.int32)], None, 1))
    cases.append(("Sum-empty-axes", "Sum", [F32, c(np.zeros(0, np.int32))], None, 1))
    for red in ("Any", "All"):
        cases.append((red, red, [BA, c([1], np.int32)], None, 1))
        cases.append((f"{red}-keep", red, [BA, c([0], np.int32)], attrs(keep_dims=True), 1))
    return cases


OP_CASES = _op_cases()


def _op_graph(op, inputs, set_attrs, n_out, live: bool):
    """A MetaGraphDef of one node: each array operand a Placeholder (live)
    or a Const, the node's outputs out0..outN."""
    meta = mg.MetaGraphDef()
    sig = meta.signature_def["serving_default"]
    g = meta.graph_def
    names, feeds = [], {}
    for k, x in enumerate(inputs):
        name = f"in{k}"
        names.append(name)
        if isinstance(x, tuple) or not live:
            arr = x[1] if isinstance(x, tuple) else x
            node = g.node.add(name=name, op="Const")
            node.attr["value"].tensor.CopyFrom(codec.from_ndarray(np.asarray(arr)))
            node.attr["dtype"].type = node.attr["value"].tensor.dtype
        else:
            g.node.add(name=name, op="Placeholder")
            sig.inputs[name].name = f"{name}:0"
            sig.inputs[name].dtype = codec.numpy_to_dtype(x.dtype)
            feeds[name] = x
    node = g.node.add(name="op", op=op)
    node.input.extend(names)
    if set_attrs is not None:
        set_attrs(node)
    for k in range(n_out):
        sig.outputs[f"out{k}"].name = f"op:{k}"
    return meta, feeds


def _run_jax(meta, feeds):
    jmeta = jax_mg.MetaGraphDef.FromString(meta.SerializeToString())
    model, params = jge.graph_model(jmeta, {}, name="op")
    with enable_x64():
        out = jax.jit(model.apply)(params, feeds)
        return {k: np.asarray(v) for k, v in out.items()}


def _run_torch(meta, feeds):
    model, params = ge.graph_model(meta, {}, name="op", device="cpu")
    out = model.apply(params, {k: torch.from_numpy(v) for k, v in feeds.items()})
    assert all(isinstance(v, torch.Tensor) for v in out.values())
    return {k: v.numpy() for k, v in out.items()}


def _assert_same(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        g, w = got[k], want[k]
        assert g.dtype == w.dtype, f"{what} {k}: dtype {g.dtype} != {w.dtype}"
        assert g.shape == w.shape, f"{what} {k}: shape {g.shape} != {w.shape}"
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


# Each case folded, and live where it has an operand that can be fed.
OP_RUNS = [(case, mode) for case in OP_CASES for mode in ("live", "static")
           if mode == "static" or not all(isinstance(x, tuple) for x in case[2])]


@pytest.mark.parametrize("case,mode", OP_RUNS, ids=[f"{m}-{c_[0]}" for c_, m in OP_RUNS])
def test_op_matches_the_jax_executor(case, mode):
    """One op on the same inputs through both executors: live operands run
    the JAX executor's jitted jnp path under enable_x64 and the port's
    torch ops; constant operands both packages' host folds. Values within
    1e-5, dtypes and shapes equal."""
    name, op, inputs, set_attrs, n_out = case
    meta, feeds = _op_graph(op, inputs, set_attrs, n_out, live=mode == "live")
    _assert_same(_run_torch(meta, feeds), _run_jax(meta, feeds), f"{name}/{mode}")


def test_every_op_of_the_table_is_a_case():
    assert set(ge._OPS) == set(jge._OPS)
    assert set(ge._OPS) - {"Where"} <= {case[1] for case in OP_CASES}


def test_where_is_refused_in_both():
    meta, feeds = _op_graph("Where", [BA], None, 1, live=True)
    with pytest.raises(jge.UnsupportedOpError, match="Where"):
        _run_jax(meta, feeds)
    with pytest.raises(ge.UnsupportedOpError, match="Where"):
        _run_torch(meta, feeds)


def test_mod_is_truncated_remainder():
    """TF's Mod/TruncateMod are C-style (the result takes the DIVIDEND's
    sign); FloorMod is Python-style, on host values and live tensors."""
    a = np.array([7, -7, 7, -7], np.int64)
    b = np.array([3, 3, -3, -3], np.int64)
    lib = ge._FunctionLibrary(mg.MetaGraphDef().graph_def)
    for op_name, want in (
        ("Mod", np.array([1, -1, 1, -1], np.int64)),
        ("TruncateMod", np.array([1, -1, 1, -1], np.int64)),
        ("FloorMod", np.array([1, 2, -2, -1], np.int64)),
    ):
        (host,) = ge._OPS[op_name](None, [a, b], ge._HOST)
        (live,) = ge._OPS[op_name](None, [torch.from_numpy(a), b],
                                   ge._Live(lib, torch.device("cpu")))
        np.testing.assert_array_equal(host, want, err_msg=op_name)
        np.testing.assert_array_equal(live.numpy(), want, err_msg=op_name)


def test_top_k_ties_take_the_lower_index_first():
    x = torch.tensor([[2.0, 5.0, 5.0, 1.0, 5.0, 5.0]])
    vals, idx = ge._t_top_k(x, 3)
    assert idx.tolist() == [[1, 2, 4]] and idx.dtype == torch.int32
    assert vals.tolist() == [[5.0, 5.0, 5.0]]


def test_live_constants_move_to_the_device_once():
    """A graph constant that meets a live tensor is copied once per device
    and reused; a fold of constants alone is computed once."""
    meta, feeds = _op_graph("Mul", [F32, c(G32)], None, 1, live=True)
    model, params = ge.graph_model(meta, {}, device="cpu")
    lib = model.apply.lib
    for _ in range(3):
        model.apply(params, {k: torch.from_numpy(v) for k, v in feeds.items()})
    assert len(lib._live_cache) == 1


# ------------------------------------------------------- named failures


def _tiny_meta(output_ref: str):
    """MetaGraphDef skeleton with one f32 input x and one output."""
    meta = mg.MetaGraphDef()
    sig = meta.signature_def["serving_default"]
    sig.inputs["x"].name = "x:0"
    sig.inputs["x"].dtype = 1
    sig.outputs["y"].name = output_ref
    sig.outputs["y"].dtype = 1
    meta.graph_def.node.add(name="x", op="Placeholder")
    return meta


def _both(meta, variables):
    """(port model, params), (JAX model, params) of one MetaGraphDef."""
    jmeta = jax_mg.MetaGraphDef.FromString(meta.SerializeToString())
    return (ge.graph_model(meta, variables, name="t", device="cpu"),
            jge.graph_model(jmeta, variables, name="t"))


def test_unsupported_op_is_named():
    meta = _tiny_meta("loop:0")
    n = meta.graph_def.node.add(name="loop", op="While")
    n.input.append("x")
    (model, params), (jmodel, jparams) = _both(meta, {})
    feeds = {"x": np.ones((2,), np.float32)}
    with pytest.raises(jge.UnsupportedOpError) as je:
        jmodel.apply(jparams, feeds)
    with pytest.raises(ge.UnsupportedOpError, match="loop.*While") as te:
        model.apply(params, feeds)
    assert str(te.value) == str(je.value)


def test_tf1_variable_v2_resolves_to_value():
    """TF1 ref-variables (VariableV2) yield the tensor value at every use
    site: a VariableV2 -> Identity -> MatMul chain sees the array."""
    meta = _tiny_meta("mm:0")
    g = meta.graph_def
    g.node.add(name="w", op="VariableV2")
    g.node.add(name="w_read", op="Identity").input.append("w")
    g.node.add(name="mm", op="MatMul").input.extend(["x", "w_read"])
    rng = np.random.RandomState(0)
    w = rng.randn(4, 3).astype(np.float32)
    x = rng.rand(5, 4).astype(np.float32)
    (model, params), (jmodel, jparams) = _both(meta, {"w": w})
    got = model.apply(params, {"x": x})["y"].numpy()
    np.testing.assert_allclose(got, x @ w, rtol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(jparams, {"x": x})["y"]),
                               rtol=1e-6)


def test_tf1_variable_v2_missing_param_is_named():
    meta = _tiny_meta("w:0")
    meta.graph_def.node.add(name="w", op="VariableV2")
    model, params = ge.graph_model(meta, {}, name="tf1", device="cpu")
    with pytest.raises(ge.GraphExecError, match="'w' not found"):
        model.apply(params, {"x": np.ones((1, 4), np.float32)})


def _dd_if_meta():
    meta = _tiny_meta("cond:0")
    g = meta.graph_def
    red = g.node.add(name="pred", op="Any")
    red.input.extend(["x", "axes"])
    ax = g.node.add(name="axes", op="Const")
    ax.attr["value"].tensor.dtype = 3
    ax.attr["value"].tensor.int_val.append(0)
    ax.attr["value"].tensor.tensor_shape.dim.add().size = 1
    cond = g.node.add(name="cond", op="StatelessIf")
    cond.input.extend(["pred", "x"])
    g.library.function.add().signature.name = "branch"
    cond.attr["then_branch"].func.name = "branch"
    cond.attr["else_branch"].func.name = "branch"
    return meta


def test_data_dependent_if_is_named():
    """An If whose predicate depends on live input is the documented,
    node-named error — whatever the feed's type, and without reading the
    predicate back from the device."""
    (model, params), (jmodel, jparams) = _both(_dd_if_meta(), {})
    feeds = {"x": np.ones((2, 2), np.float32) > 0}
    with pytest.raises(jge.UnsupportedOpError, match="data-dependent"):
        jax.jit(lambda p, b: jmodel.apply(p, b))(jparams, feeds)
    for batch in (feeds, {"x": torch.from_numpy(feeds["x"])}):
        with pytest.raises(ge.UnsupportedOpError, match="'cond'.*data-dependent"):
            model.apply(params, batch)


def test_constant_predicate_if_from_a_variable_is_inlined():
    """A config-gated If reading a captured variable: the predicate comes
    from the import-time value on the host, the chosen branch inlines."""
    meta = _tiny_meta("cond:0")
    g = meta.graph_def
    g.node.add(name="flag", op="VarHandleOp").attr["shared_name"].s = b"use_relu"
    g.node.add(name="flag_read", op="ReadVariableOp").input.append("flag")
    cond = g.node.add(name="cond", op="If")
    cond.input.extend(["flag_read", "x"])
    for fname, body_op in (("then_fn", "Relu"), ("else_fn", "Tanh")):
        fn = g.library.function.add()
        fn.signature.name = fname
        fn.signature.input_arg.add(name="a")
        fn.signature.output_arg.add(name="out")
        fn.node_def.add(name="act", op=body_op).input.append("a")
        fn.ret["out"] = "act:y:0"
    cond.attr["then_branch"].func.name = "then_fn"
    cond.attr["else_branch"].func.name = "else_fn"
    x = np.array([[-1.0, 0.5]], np.float32)
    for flag, want in ((True, np.maximum(x, 0)), (False, np.tanh(x))):
        (model, params), (jmodel, jparams) = _both(meta, {"use_relu": np.asarray(flag)})
        got = model.apply(params, {"x": torch.from_numpy(x)})["y"].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
        jgot = jax.jit(jmodel.apply)(jparams, {"x": x})["y"]
        np.testing.assert_allclose(got, np.asarray(jgot), rtol=1e-6)


def test_unresolvable_table_is_named():
    meta = _tiny_meta("find:0")
    g = meta.graph_def
    g.node.add(name="tbl", op="HashTableV2")
    f = g.node.add(name="dflt", op="Const")
    f.attr["value"].tensor.dtype = 1
    f.attr["value"].tensor.float_val.append(-1.0)
    g.node.add(name="find", op="LookupTableFindV2").input.extend(["tbl", "x", "dflt"])
    model, params = ge.graph_model(meta, {}, name="tbl_test", device="cpu")
    with pytest.raises(ge.UnsupportedOpError, match="find.*statically resolvable"):
        model.apply(params, {"x": np.ones((2, 2), np.float32)})


def test_graph_model_defaults_to_the_card():
    meta = _tiny_meta("x:0")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is taken")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ge.graph_model(meta, {})


# --------------------------------------------------- TensorFlow exports

F = 6  # fields of the exotic export

_BUILD_TF2 = f"""
import json, os, sys
import numpy as np
import tensorflow as tf

root = sys.argv[1]
F = {F}
goldens = {{}}
loaded = []  # the loaded exports stay alive: their functions read their variables


def graph_vars(path, sig):
    # The importer's graph-variable extraction (interop/savedmodel.py
    # _EXTRACT_GRAPH_SCRIPT), run here so one process serves every export.
    loaded.append(tf.saved_model.load(path))
    f = loaded[-1].signatures[sig]
    np.savez(os.path.join(root, os.path.basename(path) + "-graph.npz"),
             **{{v.name.split(":")[0]: v.numpy() for v in f.graph.variables}})
    return f


class Exotic(tf.Module):
    # Field-attention pooling, an einsum bilinear term, a residual tanh
    # block and a clipped output: outside the zoo and the generic fallback.
    def __init__(self):
        super().__init__()
        rng = np.random.RandomState(11)
        D = 8
        self.emb = tf.Variable(rng.randn(997, D).astype(np.float32), name="emb")
        self.attn = tf.Variable(rng.randn(D, 1).astype(np.float32), name="attn")
        self.bilinear = tf.Variable(rng.randn(D, D).astype(np.float32) / 8.0, name="bilinear")
        self.w1 = tf.Variable(rng.randn(D, D).astype(np.float32) / 4.0, name="w1")
        self.b1 = tf.Variable(np.zeros(D, np.float32), name="b1")
        self.w2 = tf.Variable(rng.randn(2 * D, 1).astype(np.float32) / 4.0, name="w2")

    @tf.function(input_signature=[
        tf.TensorSpec([None, F], tf.int64, name="feat_ids"),
        tf.TensorSpec([None, F], tf.float32, name="feat_wts"),
    ])
    def __call__(self, feat_ids, feat_wts):
        e = tf.gather(self.emb, tf.math.floormod(feat_ids, 997))
        e = e * feat_wts[..., None]
        scores = tf.squeeze(tf.einsum("nfd,dk->nfk", e, self.attn), -1)
        alpha = tf.nn.softmax(scores, axis=-1)
        pooled = tf.reduce_sum(e * alpha[..., None], axis=1)
        bil = tf.einsum("nd,de,ne->n", pooled, self.bilinear, pooled)
        h = tf.nn.tanh(tf.matmul(pooled, self.w1) + self.b1) + pooled
        feats = tf.concat([h, pooled], axis=-1)
        logit = tf.squeeze(tf.matmul(feats, self.w2), -1) + bil
        p = tf.clip_by_value(tf.sigmoid(logit), 1e-6, 1.0 - 1e-6)
        return {{"prediction_node": p}}


path = os.path.join(root, "exotic")
m = Exotic()
tf.saved_model.save(m, path, signatures={{"serving_default": m.__call__}})
f = graph_vars(path, "serving_default")
for seed, n in ((5, 12), (9, 10), (13, 6)):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64)
    wts = rng.rand(n, F).astype(np.float32)
    out = f(feat_ids=tf.constant(ids), feat_wts=tf.constant(wts))["prediction_node"]
    goldens[f"exotic-{{seed}}"] = out.numpy().tolist()

keys = tf.constant([10**6, 5, 42, 10**12, 77, 3], tf.int64)
vals = tf.constant([0, 1, 2, 3, 4, 5], tf.int64)


class HashTable(tf.Module):
    def __init__(self):
        super().__init__()
        rng = np.random.RandomState(31)
        self.table = tf.lookup.StaticHashTable(
            tf.lookup.KeyValueTensorInitializer(keys, vals), default_value=-1)
        self.emb = tf.Variable(rng.randn(7, 4).astype(np.float32), name="emb")

    @tf.function(input_signature=[tf.TensorSpec([None, 3], tf.int64, name="feat_ids")])
    def __call__(self, feat_ids):
        row = self.table.lookup(feat_ids)
        safe = tf.where(row < 0, tf.fill(tf.shape(row), tf.constant(6, tf.int64)), row)
        e = tf.gather(self.emb, safe)
        return {{"prediction_node": tf.math.sigmoid(tf.reduce_sum(e, axis=[1, 2]))}}


path = os.path.join(root, "hashtable")
m = HashTable()
tf.saved_model.save(m, path, signatures={{"serving_default": m.__call__}})
f = graph_vars(path, "serving_default")
ids = np.array([[5, 42, 999], [10**12, 3, 77], [1, 2, 10**6]], np.int64)
goldens["hashtable"] = f(feat_ids=tf.constant(ids))["prediction_node"].numpy().tolist()


class Cond(tf.Module):
    def __init__(self):
        super().__init__()
        rng = np.random.RandomState(41)
        self.w = tf.Variable(rng.randn(4, 3).astype(np.float32), name="w")
        self.use_relu = tf.Variable(True, trainable=False, name="use_relu")

    @tf.function(input_signature=[tf.TensorSpec([None, 4], tf.float32, name="x")])
    def __call__(self, x):
        h = tf.matmul(x, self.w)
        h = tf.cond(self.use_relu, lambda: tf.nn.relu(h), lambda: tf.nn.tanh(h))
        return {{"prediction_node": tf.reduce_sum(h, axis=1)}}


path = os.path.join(root, "cond")
m = Cond()
tf.saved_model.save(m, path, signatures={{"serving_default": m.__call__}})
f = graph_vars(path, "serving_default")
xs = np.arange(12, dtype=np.float32).reshape(3, 4) / 6.0 - 0.5
goldens["cond"] = f(x=tf.constant(xs))["prediction_node"].numpy().tolist()


class Tiny(tf.Module):
    def __init__(self):
        super().__init__()
        self.w = tf.Variable(np.random.RandomState(3).randn(4, 1).astype(np.float32), name="w")

    @tf.function(input_signature=[tf.TensorSpec([None, 4], tf.float32, name="x")])
    def score(self, x):
        return {{"prediction_node": tf.squeeze(tf.sigmoid(tf.matmul(x, self.w)), -1)}}


path = os.path.join(root, "custom_sig")
m = Tiny()
tf.saved_model.save(m, path, signatures={{"score": m.score}})
f = graph_vars(path, "score")
x = np.random.RandomState(1).rand(5, 4).astype(np.float32)
goldens["custom_sig"] = f(x=tf.constant(x))["prediction_node"].numpy().tolist()

tf.keras.utils.set_random_seed(4)
inp_ids = tf.keras.Input(shape=(5,), dtype=tf.int64, name="feat_ids")
inp_wts = tf.keras.Input(shape=(5,), dtype=tf.float32, name="feat_wts")
folded = tf.keras.layers.Lambda(lambda t: tf.math.floormod(t, 733), output_shape=(5,))(inp_ids)
emb = tf.keras.layers.Embedding(733, 6)(folded)
weighted = tf.keras.layers.Multiply()([emb, tf.keras.layers.Reshape((5, 1))(inp_wts)])
flat = tf.keras.layers.Flatten()(weighted)
h = tf.keras.layers.Dense(16, activation="relu")(flat)
h = tf.keras.layers.Dense(8, activation="tanh")(h)
p = tf.keras.layers.Dense(1, activation="sigmoid", name="out")(h)
p = tf.keras.layers.Reshape(())(p)
model = tf.keras.Model([inp_ids, inp_wts], {{"prediction_node": p}})


@tf.function(input_signature=[
    tf.TensorSpec([None, 5], tf.int64, name="feat_ids"),
    tf.TensorSpec([None, 5], tf.float32, name="feat_wts"),
])
def serve(feat_ids, feat_wts):
    return model([feat_ids, feat_wts])


path = os.path.join(root, "keras")
tf.saved_model.save(model, path, signatures={{"serving_default": serve}})
f = graph_vars(path, "serving_default")
rng = np.random.RandomState(8)
ids = rng.randint(0, 1 << 40, size=(7, 5)).astype(np.int64)
wts = rng.rand(7, 5).astype(np.float32)
goldens["keras"] = f(feat_ids=tf.constant(ids),
                     feat_wts=tf.constant(wts))["prediction_node"].numpy().tolist()
with open(os.path.join(root, "goldens.json"), "w") as fh:
    json.dump(goldens, fh)
print("built")
"""

_BUILD_TF1 = """
import json, sys
import numpy as np
import tensorflow as tf

out = sys.argv[1]
v1 = tf.compat.v1
v1.disable_eager_execution()
v1.disable_resource_variables()  # genuine VariableV2 nodes, TF1-style
rng = np.random.RandomState(21)
g = v1.Graph()
with g.as_default():
    x = v1.placeholder(tf.float32, [None, 4], name="x")
    w = v1.get_variable("w", initializer=rng.randn(4, 3).astype(np.float32))
    b = v1.get_variable("b", initializer=rng.randn(3).astype(np.float32))
    h = v1.nn.relu(v1.matmul(x, w) + b)
    w2 = v1.get_variable("w2", initializer=rng.randn(3, 1).astype(np.float32))
    y = v1.math.sigmoid(v1.squeeze(v1.matmul(h, w2), -1), name="prediction")
    with v1.Session(graph=g) as sess:
        sess.run(v1.global_variables_initializer())
        assert any(v.op.type == "VariableV2" for v in v1.global_variables())
        v1.saved_model.simple_save(sess, out, inputs={"x": x}, outputs={"prediction_node": y})
        xs = np.arange(20, dtype=np.float32).reshape(5, 4) / 10.0
        print("GOLDEN=" + json.dumps([float(v) for v in sess.run(y, {x: xs})]))
"""


def _seed_caches(export: pathlib.Path, npz: pathlib.Path) -> None:
    """Place an export's graph-variable extraction in both packages' caches
    (each keyed by the export's path and fingerprint), as the importer's own
    subprocess would."""
    for dst in (sm.graph_cache_path(export),
                jsm._default_npz_cache_path(export).with_name(
                    jsm._default_npz_cache_path(export).stem + "-graph.npz")):
        shutil.copyfile(npz, dst)


@pytest.fixture(scope="module")
def tf2(tmp_path_factory):
    """Every TF2 export of this module, built in one TensorFlow process;
    (root, TF goldens). Skips when TensorFlow is unavailable."""
    root = tmp_path_factory.mktemp("tf2")
    r = subprocess.run([sys.executable, "-c", _BUILD_TF2, str(root)],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        pytest.skip(f"tensorflow export unavailable: {r.stderr[-800:]}")
    for name in ("exotic", "hashtable", "cond", "custom_sig", "keras"):
        _seed_caches(root / name, root / f"{name}-graph.npz")
    return root, json.loads((root / "goldens.json").read_text())


@pytest.fixture(scope="module")
def tf1(tmp_path_factory):
    """A TF1-format export (simple_save over VariableV2); (dir, golden)."""
    out = tmp_path_factory.mktemp("tf1") / "tf1_sm"
    r = subprocess.run([sys.executable, "-c", _BUILD_TF1, str(out)],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        pytest.skip(f"tf1 export unavailable: {r.stderr[-800:]}")
    line = next(ln for ln in r.stdout.splitlines() if ln.startswith("GOLDEN="))
    return out, np.asarray(json.loads(line[len("GOLDEN="):]), np.float32)


def _payload(n, seed, fields=F):
    rng = np.random.RandomState(seed)
    return {
        "feat_ids": rng.randint(0, 1 << 40, size=(n, fields)).astype(np.int64),
        "feat_wts": rng.rand(n, fields).astype(np.float32),
    }


def _import_both(export, kind="graph", fields=F, **cfg):
    sv = sm.import_savedmodel(export, kind, ModelConfig(name="EX", num_fields=fields, **cfg),
                              name="EX", device="cpu")
    jsv = jsm.import_savedmodel(export, kind, JaxConfig(name="EX", num_fields=fields, **cfg),
                                name="EX")
    return sv, jsv


def _apply_both(sv, jsv, arrays, jit=False):
    got = sv.model.apply(sv.params, {k: torch.from_numpy(v) for k, v in arrays.items()})
    with enable_x64():
        fn = jax.jit(jsv.model.apply) if jit else jsv.model.apply
        want = fn(jsv.params, arrays)
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


def test_graph_executor_matches_tf_and_jax(tf2):
    root, goldens = tf2
    sv, jsv = _import_both(root / "exotic")
    assert sv.model.needs_x64 and not sv.model.folds_ids_on_host
    assert sv.model.config.num_fields == F and sv.model.kind == ""
    assert sorted(sv.signatures) == sorted(jsv.signatures)
    arrays = _payload(12, seed=5)
    got, want = _apply_both(sv, jsv, arrays, jit=True)
    np.testing.assert_allclose(got["prediction_node"], want["prediction_node"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["prediction_node"], goldens["exotic-5"],
                               rtol=2e-5, atol=1e-5)


def test_graph_extraction_subprocess_matches_the_builder(tf2, tmp_path):
    """The importer's own TF-subprocess extraction (the signature graph's
    variables by shared_name) gives the arrays the builder seeded."""
    root, _ = tf2
    out = sm.extract_graph_variables(root / "exotic", tmp_path / "g.npz")
    with np.load(out) as got, np.load(root / "exotic-graph.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k])


def test_graph_servable_over_grpc_preserves_int64(tf2):
    """The port's batcher (per-key path, no fold) and gRPC server on the
    CPU: ids past 2^31 arrive intact, scores match TF's forward."""
    root, goldens = tf2
    sv = sm.import_savedmodel(root / "exotic", "graph", ModelConfig(name="EX", num_fields=F),
                              name="EX", device="cpu")
    registry = ServableRegistry()
    registry.load(sv)
    batcher = DynamicBatcher(buckets=(32, 64), max_wait_us=0, device="cpu").start()
    impl = PredictionServiceImpl(registry, batcher)
    server, port = create_server(impl, "127.0.0.1:0")
    server.start()
    try:
        arrays = _payload(10, seed=9)
        assert arrays["feat_ids"].max() > 1 << 31
        req = apis.PredictRequest()
        req.model_spec.name = "EX"
        for k, v in arrays.items():
            req.inputs[k].CopyFrom(codec.from_ndarray(v))
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            resp = PredictionServiceStub(ch).Predict(req, timeout=60)
            meta = PredictionServiceStub(ch).GetModelMetadata(apis.GetModelMetadataRequest(
                model_spec=apis.ModelSpec(name="EX"), metadata_field=["signature_def"]),
                timeout=60)
        got = codec.to_ndarray(resp.outputs["prediction_node"])
        np.testing.assert_allclose(got, goldens["exotic-9"], rtol=2e-5, atol=1e-5)
        assert batcher.stats.h2d_copies >= 2  # per-key: one copy per input
        # int32 ids are refused: this model consumes raw int64 ids.
        req.inputs["feat_ids"].CopyFrom(codec.from_ndarray(arrays["feat_ids"].astype(np.int32)))
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            with pytest.raises(grpc.RpcError) as e:
                PredictionServiceStub(ch).Predict(req, timeout=60)
        assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        assert "signature_def" in meta.metadata
    finally:
        server.stop(0)
        batcher.stop()


def test_fallback_chain_lands_on_graph_executor(tf2, caplog):
    """kind=dcn_v2 cannot bind the exotic export, nor can the generic
    fallback; both importers land on the graph executor and agree."""
    import logging

    root, goldens = tf2
    with caplog.at_level(logging.WARNING, logger="dts_torch.interop"):
        sv, jsv = _import_both(root / "exotic", kind="dcn_v2", vocab_size=997, embed_dim=8)
    assert not sv.model.folds_ids_on_host
    assert any("GraphDef executor" in r.message for r in caplog.records
               if r.name == "dts_torch.interop")
    got, want = _apply_both(sv, jsv, _payload(6, seed=13))
    np.testing.assert_allclose(got["prediction_node"], want["prediction_node"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["prediction_node"], goldens["exotic-13"],
                               rtol=2e-5, atol=1e-5)


def test_static_hashtable_export_matches_tf(tf2):
    root, goldens = tf2
    sv, jsv = _import_both(root / "hashtable", fields=3)
    assert sv.model.apply.lib.tables
    ids = np.array([[5, 42, 999], [10**12, 3, 77], [1, 2, 10**6]], np.int64)
    got, want = _apply_both(sv, jsv, {"feat_ids": ids}, jit=True)
    np.testing.assert_allclose(got["prediction_node"], goldens["hashtable"],
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got["prediction_node"], want["prediction_node"],
                               rtol=1e-5, atol=1e-6)


def test_constant_predicate_cond_export(tf2):
    root, goldens = tf2
    sv, jsv = _import_both(root / "cond", fields=4)
    xs = np.arange(12, dtype=np.float32).reshape(3, 4) / 6.0 - 0.5
    got, want = _apply_both(sv, jsv, {"x": xs}, jit=True)
    np.testing.assert_allclose(got["prediction_node"], goldens["cond"], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got["prediction_node"], want["prediction_node"],
                               rtol=1e-5, atol=1e-6)


def test_executor_rejects_unknown_signature(tf2):
    root, _ = tf2
    meta = sm.serve_meta_graph(sm.read_saved_model(root / "exotic"))
    with pytest.raises(ge.GraphExecError, match="nope"):
        ge.GraphExecutor(meta, "nope")


def test_graph_import_without_serving_default(tf2):
    """An export whose only signature has a custom name threads that ONE
    name through extraction, executor build and the dry-run probe."""
    root, goldens = tf2
    sv, jsv = _import_both(root / "custom_sig", fields=4)
    x = np.random.RandomState(1).rand(5, 4).astype(np.float32)
    got, want = _apply_both(sv, jsv, {"x": x})
    assert got["prediction_node"].shape == (5,)
    np.testing.assert_allclose(got["prediction_node"], goldens["custom_sig"], rtol=2e-5)
    np.testing.assert_allclose(got["prediction_node"], want["prediction_node"], rtol=1e-5)


def test_keras_export_serves_via_graph_executor(tf2):
    root, goldens = tf2
    sv, jsv = _import_both(root / "keras", fields=5)
    rng = np.random.RandomState(8)
    arrays = {"feat_ids": rng.randint(0, 1 << 40, size=(7, 5)).astype(np.int64),
              "feat_wts": rng.rand(7, 5).astype(np.float32)}
    got, want = _apply_both(sv, jsv, arrays, jit=True)
    np.testing.assert_allclose(got["prediction_node"], goldens["keras"], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got["prediction_node"], want["prediction_node"],
                               rtol=1e-5, atol=1e-6)


def test_tf1_savedmodel_end_to_end(tf1):
    """A TF1-format export: the importer's extraction subprocess takes the
    checkpoint branch (VariableV2 names), and the executor matches the TF1
    session's forward and the JAX executor."""
    export, want = tf1
    sv = sm.import_savedmodel(export, "graph", ModelConfig(name="T1", num_fields=4),
                              name="T1", device="cpu")
    shutil.copyfile(sm.graph_cache_path(export),
                    jsm._default_npz_cache_path(export).with_name(
                        jsm._default_npz_cache_path(export).stem + "-graph.npz"))
    jsv = jsm.import_savedmodel(export, "graph", JaxConfig(name="T1", num_fields=4), name="T1")
    xs = np.arange(20, dtype=np.float32).reshape(5, 4) / 10.0
    got, jgot = _apply_both(sv, jsv, {"x": xs})
    np.testing.assert_allclose(got["prediction_node"], want, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got["prediction_node"], jgot["prediction_node"], rtol=1e-5)
