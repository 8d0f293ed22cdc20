"""Servable registry: model name -> versions -> signatures.

ModelSpec resolution semantics of TF-Serving: requests name a model,
optionally pin a version (absent => latest loaded version) or a version
label, and select a signature by name (default "serving_default").
GetModelMetadata serves the stored SignatureDefs.

The proto bindings are imported lazily inside the functions that build
protobuf messages, so this module (and the batcher) import without
protobuf installed.
"""

from __future__ import annotations

import dataclasses
import functools
import threading

from .base import Batch, Model, Params

# TF-Serving method names carried in SignatureDef.method_name.
PREDICT_METHOD = "tensorflow/serving/predict"
CLASSIFY_METHOD = "tensorflow/serving/classify"
REGRESS_METHOD = "tensorflow/serving/regress"

DEFAULT_SIGNATURE = "serving_default"


class ModelNotFoundError(KeyError):
    pass


class VersionNotFoundError(KeyError):
    pass


class SignatureNotFoundError(KeyError):
    pass


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    name: str  # logical tensor alias (the request/response map key)
    dtype: int  # fw.DataType value
    # Per-dim None = unknown/batch dim; whole-shape None = unknown rank.
    shape: tuple[int | None, ...] | None

    def to_tensor_info(self):
        from ..proto import tf_meta_graph_pb2 as mg

        info = mg.TensorInfo(name=f"{self.name}:0", dtype=self.dtype)
        if self.shape is None:
            info.tensor_shape.unknown_rank = True
        else:
            for s in self.shape:
                info.tensor_shape.dim.add(size=-1 if s is None else s)
        return info


@dataclasses.dataclass(frozen=True)
class Signature:
    """One servable signature: typed I/O contract + method name."""

    inputs: tuple[TensorSpec, ...]
    outputs: tuple[TensorSpec, ...]
    method_name: str = PREDICT_METHOD

    @functools.cached_property
    def input_specs(self) -> dict[str, TensorSpec]:
        return {s.name: s for s in self.inputs}

    @functools.cached_property
    def output_names(self) -> list[str]:
        return [s.name for s in self.outputs]

    def to_signature_def(self):
        from ..proto import tf_meta_graph_pb2 as mg

        sd = mg.SignatureDef(method_name=self.method_name)
        for spec in self.inputs:
            sd.inputs[spec.name].CopyFrom(spec.to_tensor_info())
        for spec in self.outputs:
            sd.outputs[spec.name].CopyFrom(spec.to_tensor_info())
        return sd


def ctr_signatures(num_fields: int, with_dense: int | None = None) -> dict[str, Signature]:
    """The standard CTR signature set (feat_ids int64 [n,F] + feat_wts
    float [n,F] -> prediction_node [n])."""
    # DataType values from types.proto (wire-frozen): DT_FLOAT=1,
    # DT_STRING=7, DT_INT64=9.
    DT_FLOAT, DT_STRING, DT_INT64 = 1, 7, 9
    inputs = [
        TensorSpec("feat_ids", DT_INT64, (None, num_fields)),
        TensorSpec("feat_wts", DT_FLOAT, (None, num_fields)),
    ]
    if with_dense:
        inputs.append(TensorSpec("dense_features", DT_FLOAT, (None, with_dense)))
    predict = Signature(
        inputs=tuple(inputs),
        outputs=(
            TensorSpec("prediction_node", DT_FLOAT, (None,)),
            TensorSpec("logits", DT_FLOAT, (None,)),
        ),
        method_name=PREDICT_METHOD,
    )
    classify = dataclasses.replace(
        predict,
        outputs=(
            TensorSpec("scores", DT_FLOAT, (None, 2)),
            TensorSpec("classes", DT_STRING, (None, 2)),
        ),
        method_name=CLASSIFY_METHOD,
    )
    regress = dataclasses.replace(
        predict,
        outputs=(TensorSpec("outputs", DT_FLOAT, (None,)),),
        method_name=REGRESS_METHOD,
    )
    return {DEFAULT_SIGNATURE: predict, "classify": classify, "regress": regress}


def model_signatures(model: Model) -> dict[str, Signature]:
    """The signature set of a built model: ctr_signatures over its fields,
    plus the optional dense_features input for a dlrm model."""
    cfg = model.config
    dense = cfg.num_dense_features if model.kind == "dlrm" else None
    return ctr_signatures(cfg.num_fields, with_dense=dense)


@dataclasses.dataclass(eq=False)  # identity hash: used as a weak cache key
class Servable:
    """A loaded (model, params) pair plus its signature map."""

    name: str
    version: int
    model: Model
    params: Params
    signatures: dict[str, Signature]

    def signature(self, name: str) -> Signature:
        key = name or DEFAULT_SIGNATURE
        if key not in self.signatures:
            raise SignatureNotFoundError(
                f"signature {key!r} not found in servable {self.name} v{self.version}; "
                f"have {sorted(self.signatures)}"
            )
        return self.signatures[key]

    def __call__(self, batch: Batch) -> dict:
        return self.model.apply(self.params, batch)

    def signature_def_map(self) -> dict:
        return {k: v.to_signature_def() for k, v in self.signatures.items()}


class ServableRegistry:
    """Thread-safe name -> {version -> Servable} store, with version labels
    (a label such as "stable"/"canary" names ONE loaded version)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._servables: dict[str, dict[int, Servable]] = {}
        self._labels: dict[str, dict[str, int]] = {}

    def load(self, servable: Servable) -> None:
        with self._lock:
            self._servables.setdefault(servable.name, {})[servable.version] = servable

    def unload(self, name: str, version: int | None = None) -> None:
        with self._lock:
            if name not in self._servables:
                raise ModelNotFoundError(name)
            if version is None:
                del self._servables[name]
                self._labels.pop(name, None)
                return
            versions = self._servables[name]
            if version not in versions:
                raise VersionNotFoundError(f"{name} v{version}")
            del versions[version]
            labels = self._labels.get(name)
            if labels:
                # A label never dangles onto an unloaded version.
                for label in [l for l, v in labels.items() if v == version]:
                    del labels[label]
            if not versions:
                del self._servables[name]
                self._labels.pop(name, None)

    def set_label(self, name: str, label: str, version: int) -> None:
        """Point `label` at a LOADED version."""
        if not label:
            raise ValueError("version label must be non-empty")
        with self._lock:
            self._check_labelable(name, label, version)
            self._labels.setdefault(name, {})[label] = version

    def _check_labelable(self, name: str, label: str, version: int) -> None:
        """Raise unless `name` v`version` is loaded. Caller holds the lock."""
        versions = self._servables.get(name)
        if not versions:
            raise ModelNotFoundError(f"model {name!r} not loaded")
        if version not in versions:
            raise VersionNotFoundError(
                f"cannot label {name!r} v{version} as {label!r}: version not "
                f"loaded; have {sorted(versions)}"
            )

    def replace_label_maps(self, maps: dict[str, dict[str, int]]) -> None:
        """Replace each named model's whole label map, atomically across all
        models (HandleReloadConfigRequest: the supplied map is the
        declarative state, so a label absent from it is unassigned). Every
        label is checked before any is applied, under one lock acquisition:
        a bad label, or a concurrent unload, applies nothing."""
        with self._lock:
            for name, mapping in maps.items():
                for label, version in mapping.items():
                    if not label:
                        raise ValueError("version label must be non-empty")
                    self._check_labelable(name, label, version)
            for name, mapping in maps.items():
                self._labels[name] = dict(mapping)

    def resolve(
        self,
        name: str,
        version: int | None = None,
        label: str | None = None,
    ) -> Servable:
        """Absent version => latest; a label => the labeled version.
        version XOR label is enforced by the caller."""
        with self._lock:
            versions = self._servables.get(name)
            if not versions:
                raise ModelNotFoundError(f"model {name!r} not loaded")
            if label is not None:
                assigned = self._labels.get(name, {})
                if label not in assigned:
                    raise VersionNotFoundError(
                        f"model {name!r} has no version label {label!r}; "
                        f"have {sorted(assigned)}"
                    )
                version = assigned[label]
            if version is None:
                return versions[max(versions)]
            if version not in versions:
                raise VersionNotFoundError(
                    f"model {name!r} has no version {version}; have {sorted(versions)}"
                )
            return versions[version]

    def models(self) -> dict[str, list[int]]:
        with self._lock:
            return {k: sorted(v) for k, v in self._servables.items()}

    def labels(self, name: str) -> dict[str, int]:
        with self._lock:
            return dict(self._labels.get(name, {}))
