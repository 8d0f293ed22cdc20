"""The benchmark's own wire copy against the program's generated protos."""

import numpy as np

from ctrbench.harness import wire
from distributed_tf_serving_tpu_torch import codec
from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis


def test_varints_are_canonical():
    vals = np.array([0, 1, 127, 128, 300, 2 ** 35, 2 ** 40 - 1, 2 ** 62], np.int64)
    expect = b"".join(wire._varint(int(v)) for v in vals)
    assert wire.varints(vals) == expect
    assert wire.varints(np.full(5, 2 ** 40 - 1)) == wire._varint(2 ** 40 - 1) * 5


def test_request_parses_with_the_program_protos():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 2 ** 40, size=(37, 43), dtype=np.int64)
    wts = rng.random((37, 43), dtype=np.float32)
    dense = rng.random((37, 13), dtype=np.float32)
    data = wire.encode_predict("DLRM", {"feat_ids": ids, "feat_wts": wts,
                                        "dense_features": dense}, ("prediction_node",))
    req = apis.PredictRequest()
    req.ParseFromString(data)
    assert req.model_spec.name == "DLRM" and list(req.output_filter) == ["prediction_node"]
    assert len(req.inputs["feat_ids"].int64_val) == ids.size  # the grpc-java encoding
    assert np.array_equal(codec.to_ndarray(req.inputs["feat_ids"]), ids)
    assert np.array_equal(codec.to_ndarray(req.inputs["feat_wts"]), wts)
    assert np.array_equal(codec.to_ndarray(req.inputs["dense_features"]), dense)


def test_response_decodes_both_encodings():
    s = np.random.default_rng(2).random(1500, dtype=np.float32)
    for content in (True, False):
        resp = apis.PredictResponse()
        resp.outputs["prediction_node"].CopyFrom(codec.from_ndarray(s, use_tensor_content=content))
        out = wire.decode_predict_response(resp.SerializeToString())
        assert np.array_equal(out["prediction_node"], s)
