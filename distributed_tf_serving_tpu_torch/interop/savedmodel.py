"""SavedModel importer: TF-Serving's on-disk format -> a port Servable.

Split by dependency, so serving never imports TensorFlow:

1. `read_saved_model` / `signatures_from_meta_graph` — parse
   `saved_model.pb` with the vendored wire-compatible bindings
   (proto/tf_saved_model_pb2.py); the exported SignatureDefs
   (meta_graph.proto:297-311 upstream) become the Servable's signature map,
   so GetModelMetadata answers exactly what the original export declared.
2. `extract_variables` — one-shot subprocess running TensorFlow's
   checkpoint reader over `variables/variables.*` (TensorBundle is TF's
   private format) and dumping a plain `.npz`. TF must not be imported in
   this process: both register `tensorflow.*` symbols in the default
   descriptor pool and collide. A machine without TensorFlow serves an
   export that ships a fresh `variables_extracted.npz`, or whose
   extraction is already in this package's cache.
3. `map_variables` — places the extracted arrays into a model-zoo param
   tree: explicit {param-path: variable-name} mapping when given, otherwise
   role- then shape-matching with an order-based tiebreak for repeated
   shapes (MLP stacks); ambiguity fails loudly rather than guessing.

`import_savedmodel` composes the three into a registry-ready Servable, its
params tensors on the serving device; exports that bind to no zoo family
fall back to the generic embed+MLP family, then to the GraphDef executor
(interop/graph_exec.py). The CLI (`python -m
distributed_tf_serving_tpu_torch.interop.savedmodel`) converts a
SavedModel directory into a checkpoint of train/checkpoint.py for
`--checkpoint` serving.
"""

from __future__ import annotations

import json
import logging
import os
import pathlib
import re
import subprocess
import sys
import textwrap
import time

import numpy as np
import torch

from ..models.base import ModelConfig, build_model, resolve_device
from ..models.registry import Servable, Signature, TensorSpec

log = logging.getLogger("dts_torch.interop")

SERVE_TAG = "serve"
# Object-graph checkpoints suffix every value; strip for readable names.
_ATTR_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"


class SavedModelImportError(RuntimeError):
    pass


# --------------------------------------------------------------- metadata


def read_saved_model(saved_model_dir):
    """Parse `saved_model.pb` natively; returns the SavedModel proto."""
    from ..proto import tf_saved_model_pb2 as sm

    path = pathlib.Path(saved_model_dir) / "saved_model.pb"
    if not path.exists():
        raise SavedModelImportError(f"{path} not found (not a SavedModel dir?)")
    proto = sm.SavedModel()
    proto.ParseFromString(path.read_bytes())
    if not proto.meta_graphs:
        raise SavedModelImportError(f"{path} contains no meta graphs")
    return proto


def serve_meta_graph(saved_model):
    """The MetaGraphDef tagged `serve` (TF-Serving's loader selects by tag;
    meta_graph.proto:62-66 upstream), falling back to the only graph."""
    for mg in saved_model.meta_graphs:
        if SERVE_TAG in mg.meta_info_def.tags:
            return mg
    if len(saved_model.meta_graphs) == 1:
        return saved_model.meta_graphs[0]
    tags = [list(m.meta_info_def.tags) for m in saved_model.meta_graphs]
    raise SavedModelImportError(f"no meta graph tagged {SERVE_TAG!r}; have {tags}")


def signatures_from_meta_graph(meta_graph) -> dict[str, Signature]:
    """SignatureDef map -> Signature map (alias keys, dtypes, shapes
    preserved; -1/unknown dims become None)."""

    def specs(infos) -> tuple[TensorSpec, ...]:
        out = []
        for alias, info in sorted(infos.items()):
            if info.tensor_shape.unknown_rank:
                dims = None  # unknown rank, not a scalar (tensor_shape.proto)
            else:
                dims = tuple(
                    None if d.size < 0 else int(d.size) for d in info.tensor_shape.dim
                )
            out.append(TensorSpec(name=alias, dtype=info.dtype, shape=dims))
        return tuple(out)

    sigs = {}
    for name, sd in meta_graph.signature_def.items():
        sigs[name] = Signature(
            inputs=specs(sd.inputs),
            outputs=specs(sd.outputs),
            method_name=sd.method_name,
        )
    if not sigs:
        raise SavedModelImportError("SavedModel declares no signatures")
    return sigs


# -------------------------------------------------------------- variables

_EXTRACT_SCRIPT = textwrap.dedent(
    """
    import sys
    import numpy as np
    import tensorflow as tf

    prefix, out = sys.argv[1], sys.argv[2]
    reader = tf.train.load_checkpoint(prefix)
    arrays = {}
    for name in reader.get_variable_to_shape_map():
        if (
            "OBJECT_GRAPH" in name
            or "/.OPTIMIZER_SLOT/" in name
            or name.split("/")[0] == "save_counter"
        ):
            continue  # bookkeeping / optimizer state, not servable weights
        arrays[name] = reader.get_tensor(name)
    np.savez(out, **arrays)
    print(f"extracted {len(arrays)} variables")
    """
)


def extract_variables(saved_model_dir, out_npz, python: str = sys.executable) -> pathlib.Path:
    """Dump the SavedModel's variables to `.npz` via a TensorFlow subprocess.

    TF is only needed here (its TensorBundle reader); the output npz is the
    cacheable, TF-free artifact everything downstream consumes.
    """
    prefix = pathlib.Path(saved_model_dir) / "variables" / "variables"
    out_npz = pathlib.Path(out_npz)
    proc = subprocess.run(
        [python, "-c", _EXTRACT_SCRIPT, str(prefix), str(out_npz)],
        capture_output=True,
        text=True,
        timeout=600,
    )
    if proc.returncode != 0:
        raise SavedModelImportError(
            f"variable extraction failed (is tensorflow importable by {python}?):\n"
            f"{proc.stderr.strip()[-2000:]}"
        )
    return out_npz


# Graph-executor binding needs variables keyed by the serving graph's
# VarHandleOp shared_name (what ReadVariableOp resolves), not by checkpoint
# object paths; tf.saved_model.load restores variables under exactly those
# names (tf 2.21 exports), so the loaded signature graph is the
# authoritative name source.
_EXTRACT_GRAPH_SCRIPT = textwrap.dedent(
    """
    import sys
    import numpy as np
    import tensorflow as tf

    src, out, sig_name = sys.argv[1], sys.argv[2], sys.argv[3]
    obj = tf.saved_model.load(src)
    f = obj.signatures[sig_name] if sig_name in obj.signatures else (
        next(iter(obj.signatures.values()))
    )
    arrays = {}
    for v in f.graph.variables:
        arrays[v.name.split(":")[0]] = v.numpy()
    if not arrays:
        # TF1-format SavedModel (simple_save / SavedModelBuilder): the v1
        # loader wrapper exposes no f.graph.variables, but its TensorBundle
        # stores values under the VariableV2 node names directly — exactly
        # the keys the graph executor binds (graph_exec.py VariableV2).
        import os
        prefix = os.path.join(src, "variables", "variables")
        reader = tf.train.load_checkpoint(prefix)
        for name in reader.get_variable_to_shape_map():
            arrays[name] = reader.get_tensor(name)
    np.savez(out, **arrays)
    print(f"extracted {len(arrays)} graph variables")
    """
)


def extract_graph_variables(
    saved_model_dir, out_npz, signature_name: str = "serving_default",
    python: str = sys.executable,
) -> pathlib.Path:
    """Dump the serving signature's variables keyed by shared_name (the
    graph-executor binding) via a TensorFlow subprocess."""
    out_npz = pathlib.Path(out_npz)
    proc = subprocess.run(
        [python, "-c", _EXTRACT_GRAPH_SCRIPT, str(saved_model_dir), str(out_npz),
         signature_name],
        capture_output=True,
        text=True,
        timeout=600,
    )
    if proc.returncode != 0:
        raise SavedModelImportError(
            f"graph-variable extraction failed (is tensorflow importable by "
            f"{python}?):\n{proc.stderr.strip()[-2000:]}"
        )
    return out_npz


def _clean_name(name: str) -> str:
    return name[: -len(_ATTR_SUFFIX)] if name.endswith(_ATTR_SUFFIX) else name


def _is_bookkeeping(name: str) -> bool:
    """TF checkpoint bookkeeping that must never bind to model params (also
    filtered at extraction; re-checked here for pre-extracted npz files)."""
    return (
        name.split("/")[0] == "save_counter"
        or "OBJECT_GRAPH" in name
        or "/.OPTIMIZER_SLOT/" in name
    )


def _natural_key(name: str):
    """Numeric-aware sort: layer_2 before layer_10 (plain lexicographic
    ordering would shuffle same-shape stacks past 10 layers)."""
    return [int(tok) if tok.isdigit() else tok for tok in re.split(r"(\d+)", name)]


def _flatten_params(tree, prefix=()) -> dict:
    """Nested dict/list param tree -> {'a/b/0/w': leaf} paths, in the
    tree's own order."""
    flat = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {"/".join(map(str, prefix)): tree}
    for key, sub in items:
        flat.update(_flatten_params(sub, prefix + (str(key),)))
    return flat


def _unflatten_like(template, flat: dict, prefix=()):
    if isinstance(template, dict):
        return {k: _unflatten_like(v, flat, prefix + (str(k),)) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        seq = [_unflatten_like(v, flat, prefix + (str(i),)) for i, v in enumerate(template)]
        return type(template)(seq) if isinstance(template, tuple) else seq
    return flat["/".join(map(str, prefix))]


def _jax_order(tree):
    """A param tree with every dict's keys sorted: the order in which the
    JAX package walks a model's template (jax.tree.map rebuilds dicts with
    sorted keys), so one export binds the same leaves, and fails with the
    same first message, in both packages."""
    if isinstance(tree, dict):
        return {k: _jax_order(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_jax_order(v) for v in tree)
    return tree


def _leaf_shape(leaf) -> tuple:
    return tuple(int(d) for d in np.shape(leaf)) if not isinstance(leaf, torch.Tensor) \
        else tuple(int(d) for d in leaf.shape)


def _leaf_np_dtype(leaf) -> np.dtype:
    """A template leaf's dtype as numpy holds it (bf16, which numpy lacks,
    is held as float32 and cast when the leaf becomes a tensor)."""
    if isinstance(leaf, torch.Tensor):
        return np.dtype(np.float32) if leaf.dtype == torch.bfloat16 else \
            torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


# Name-pattern roles for mapping-free import of real-world exports.
# Keras/estimator exports carry a standard vocabulary (dense_1/kernel,
# embedding/embeddings, linear/linear_model/..., tfrs cross layers);
# classifying both sides into coarse roles lets same-shape kernels from
# DIFFERENT groups (a cross (d,d) vs an MLP (d,d)) bind without an explicit
# mapping. First match wins, so the more specific roles come first.
_VAR_ROLE_PATTERNS: tuple[tuple[str, str], ...] = (
    ("embedding", r"embedding|embeddings|emb_|_emb\b|lookup_table"),
    ("wide", r"wide|linear_model|(^|/)linear(/|$)"),
    ("cross", r"cross"),
    ("user", r"user|query"),
    ("item", r"(^|/|_)item|candidate"),
    ("out", r"logits|output|head|prediction|score|(^|/)out(/|$)"),
    ("deep", r"dense|dnn|deep|mlp|hidden|(^|/)fc|sequential|tower"),
)

_PARAM_ROLE_PATTERNS: tuple[tuple[str, str], ...] = (
    ("embedding", r"embedding"),
    ("wide", r"wide|linear"),
    ("cross", r"cross"),
    ("user", r"user"),
    ("item", r"item"),
    ("out", r"(^|/)out(/|$)|bias"),
    ("deep", r"mlp"),
)


def _role(name: str, patterns) -> str:
    low = name.lower()
    for role, pat in patterns:
        if re.search(pat, low):
            return role
    return "other"


def map_variables(
    variables: dict[str, np.ndarray],
    target_params,
    mapping: dict[str, str] | None = None,
):
    """Place extracted TF variables into a model-zoo param tree.

    `target_params` is the template: a tree whose leaves give each param's
    shape and dtype (numpy arrays, or torch tensors such as a model's
    `shapes()` on the meta device), walked in its own order. Returns the
    same tree of numpy arrays, each cast to its leaf's dtype.

    `mapping` is {our-param-path: tf-variable-name} and wins outright
    (variable names accepted with or without the checkpoint's
    `/.ATTRIBUTES/VARIABLE_VALUE` suffix). Without it, two passes:

    1. *Role pass* — both sides are classified into coarse semantic roles by
       name patterns (_VAR_ROLE_PATTERNS: the common Keras/estimator export
       vocabulary; _PARAM_ROLE_PATTERNS: the zoo's own tree vocabulary).
       Within a (role, shape) bucket whose candidate counts agree, variables
       bind to params in natural-sorted-name vs tree order. Buckets that
       don't line up defer — the role pass never errors.
    2. *Shape pass* — leftovers bind by exact shape; a shape held by exactly
       one variable and one slot binds directly; repeated shapes bind in
       natural order only within one indexed stack. Leftover ambiguity or
       mismatch raises with the full candidate list.
    """
    variables = {
        _clean_name(k): np.asarray(v)
        for k, v in variables.items()
        if not _is_bookkeeping(_clean_name(k))
    }
    flat_target = _flatten_params(target_params)
    chosen: dict[str, str] = {}

    if mapping:
        mapping = {p: _clean_name(v) for p, v in mapping.items()}
        missing = set(mapping) - set(flat_target)
        if missing:
            raise SavedModelImportError(f"mapping names unknown param paths: {sorted(missing)}")
        bad_vars = set(mapping.values()) - set(variables)
        if bad_vars:
            raise SavedModelImportError(
                f"mapping names unknown variables: {sorted(bad_vars)}; "
                f"available: {sorted(variables)}"
            )
        chosen.update(mapping)

    def remaining():
        used = set(chosen.values())
        params = [p for p in flat_target if p not in chosen]  # tree order
        varnames = [v for v in sorted(variables, key=_natural_key) if v not in used]
        return params, varnames

    # ---- pass 1: role-partitioned shape matching (defer on any mismatch)
    unmapped_params, unused_vars = remaining()
    buckets: dict[tuple[str, tuple], tuple[list[str], list[str]]] = {}
    for p in unmapped_params:
        key = (_role(p, _PARAM_ROLE_PATTERNS), _leaf_shape(flat_target[p]))
        buckets.setdefault(key, ([], []))[0].append(p)
    for v in unused_vars:
        key = (_role(v, _VAR_ROLE_PATTERNS), tuple(variables[v].shape))
        if key in buckets:
            buckets[key][1].append(v)
    for (role, _shape), (params, cands) in buckets.items():
        if role == "other" or not params or len(params) != len(cands):
            continue  # defer to the shape pass
        if len(params) > 1 and len({re.sub(r"\d+", "#", p) for p in params}) > 1:
            continue  # multiple stacks share (role, shape): don't guess here
        for p, v in zip(params, cands):
            chosen[p] = v

    # ---- pass 2: global shape matching over whatever the role pass left
    unmapped_params, unused_vars = remaining()
    by_shape_vars: dict[tuple, list[str]] = {}
    for v in unused_vars:
        by_shape_vars.setdefault(tuple(variables[v].shape), []).append(v)
    by_shape_params: dict[tuple, list[str]] = {}
    for p in unmapped_params:  # tree order
        by_shape_params.setdefault(_leaf_shape(flat_target[p]), []).append(p)

    for shape, params in by_shape_params.items():
        cands = by_shape_vars.get(shape, [])
        if len(cands) < len(params):
            raise SavedModelImportError(
                f"no variable of shape {shape} for param(s) {params}; "
                f"unused variables: { {v: variables[v].shape for v in unused_vars} }"
            )
        if len(cands) > len(params):
            raise SavedModelImportError(
                f"ambiguous shape {shape}: params {params} vs variables {cands}; "
                "pass an explicit mapping for these"
            )
        if len(params) > 1:
            # Order-based binding is only trustworthy within ONE indexed
            # stack (cross/0/w, cross/1/w, ...). Same-shape params from
            # different groups (a cross kernel and an MLP kernel both
            # (16,16)) would zip against variable names whose sort order
            # has no relation to our tree order — fail instead of guessing.
            stems = {re.sub(r"\d+", "#", p) for p in params}
            if len(stems) > 1:
                raise SavedModelImportError(
                    f"shape {shape} is shared across different param groups "
                    f"{sorted(stems)} ({params}); order-based matching would "
                    "guess — pass an explicit mapping for these"
                )
        for p, v in zip(params, cands):
            chosen[p] = v

    flat_out = {}
    for path, var_name in chosen.items():
        arr = variables[var_name]
        want = flat_target[path]
        if tuple(arr.shape) != _leaf_shape(want):
            raise SavedModelImportError(
                f"shape mismatch for {path}: param {_leaf_shape(want)} vs "
                f"variable {var_name} {arr.shape}"
            )
        flat_out[path] = arr.astype(_leaf_np_dtype(want), copy=False)
    return _unflatten_like(target_params, flat_out)


def infer_generic_architecture(
    variables: dict[str, np.ndarray],
    signatures: dict | None,
    config: ModelConfig,
) -> tuple[ModelConfig, dict[str, str]]:
    """Classify a non-zoo export as "embedding bag -> dense chain -> logit"
    and derive the generic family's config + an EXPLICIT variable mapping
    from the export's own shapes (the best-effort fallback at the import
    boundary). Raises SavedModelImportError with the structural reason when
    the export is not that shape — the caller folds it into the actionable
    rejection.

    Inference rules:
    - the embedding table is the 2-D variable classified `embedding` by
      name (falling back to the largest-rows 2-D variable); its shape gives
      (vocab_size, embed_dim);
    - num_fields comes from the serving_default `feat_ids` spec when the
      export declares it, else the caller's config;
    - the dense chain is recovered by shape-chaining: kernels must form one
      sequence in_0=F*D -> ... -> out_n=1 using EVERY non-embedding 2-D
      variable exactly once (depth-first over same-in-dim alternatives), so
      no weight is silently dropped; each kernel's bias binds by sibling
      name (kernel->bias) or uniquely by shape.
    """
    variables = {
        _clean_name(k): np.asarray(v)
        for k, v in variables.items()
        if not _is_bookkeeping(_clean_name(k))
    }

    num_fields = config.num_fields
    sig = (signatures or {}).get("serving_default")
    if sig is not None:
        for spec in sig.inputs:
            if spec.name == "feat_ids" and spec.shape and len(spec.shape) == 2:
                if spec.shape[1]:
                    num_fields = int(spec.shape[1])

    two_d = {k: v for k, v in variables.items() if v.ndim == 2}
    one_d = {k: v for k, v in variables.items() if v.ndim == 1}
    other = {k: v for k, v in variables.items() if v.ndim not in (1, 2)}
    if other:
        raise SavedModelImportError(
            f"generic fallback handles only matrix/vector variables; found "
            f"{ {k: v.shape for k, v in other.items()} }"
        )
    if not two_d:
        raise SavedModelImportError("generic fallback found no 2-D variables at all")

    emb_named = [k for k in two_d if _role(k, _VAR_ROLE_PATTERNS) == "embedding"]
    if len(emb_named) == 1:
        emb_name = emb_named[0]
    elif len(emb_named) > 1:
        raise SavedModelImportError(
            f"generic fallback found several embedding-like tables "
            f"{sorted(emb_named)}; cannot pick one"
        )
    else:
        emb_name = max(two_d, key=lambda k: two_d[k].shape[0])
    vocab_size, embed_dim = map(int, two_d[emb_name].shape)
    d0 = num_fields * embed_dim
    kernels = {k: v for k, v in two_d.items() if k != emb_name}

    # Depth-first shape-chaining: one ordering that consumes every kernel.
    # Branching is bounded: same-shape kernels are interchangeable, so each
    # level tries ONE candidate per distinct shape (natural-name order
    # within a shape keeps stacked layers stable), and dead (cur_dim,
    # remaining) states are memoized — without this, a dozen uniform-width
    # kernels with no valid chain would backtrack factorially.
    dead: set[tuple[int, frozenset]] = set()

    def chain(cur_dim: int, remaining: frozenset) -> list[str] | None:
        if not remaining:
            return []
        if (cur_dim, remaining) in dead:
            return None
        tried_shapes = set()
        for k in sorted(remaining, key=_natural_key):
            rows, cols = kernels[k].shape
            if rows != cur_dim or (rows, cols) in tried_shapes:
                continue
            tried_shapes.add((rows, cols))
            if not remaining - {k} and cols != 1:
                continue  # the last kernel must emit the logit
            rest = chain(cols, remaining - {k})
            if rest is not None:
                return [k] + rest
        dead.add((cur_dim, remaining))
        return None

    order = chain(d0, frozenset(kernels))
    if order is None:
        raise SavedModelImportError(
            f"dense kernels { {k: v.shape for k, v in kernels.items()} } do not "
            f"chain from F*D={d0} (num_fields={num_fields} x embed_dim="
            f"{embed_dim}) down to a 1-wide logit using every kernel"
        )

    def bias_for(kernel_name: str, width: int, used: set) -> str:
        sibling = re.sub(r"kernel|weights?$", "bias", kernel_name)
        if sibling != kernel_name and sibling in one_d and sibling not in used:
            return sibling
        by_shape = [
            k for k, v in one_d.items() if v.shape == (width,) and k not in used
        ]
        if len(by_shape) == 1:
            return by_shape[0]
        raise SavedModelImportError(
            f"no unambiguous bias of width {width} for kernel {kernel_name!r}; "
            f"candidates: {by_shape}"
        )

    mapping: dict[str, str] = {"embedding": emb_name}
    used_biases: set[str] = set()
    mlp_dims = []
    for i, k in enumerate(order):
        width = int(kernels[k].shape[1])
        b = bias_for(k, width, used_biases)
        used_biases.add(b)
        if i < len(order) - 1:
            mapping[f"mlp/{i}/w"] = k
            mapping[f"mlp/{i}/b"] = b
            mlp_dims.append(width)
        else:
            mapping["out/w"] = k
            mapping["out/b"] = b
    unused = set(one_d) - used_biases
    if unused:
        raise SavedModelImportError(
            f"generic fallback would leave vector variables unbound: "
            f"{ {k: one_d[k].shape for k in sorted(unused)} } (batch-norm "
            "stats or non-bias vectors are outside the embed+MLP shape)"
        )

    import dataclasses as dc

    generic_config = dc.replace(
        config,
        num_fields=num_fields,
        vocab_size=vocab_size,
        embed_dim=embed_dim,
        mlp_dims=tuple(mlp_dims),
    )
    return generic_config, mapping


def _check_signature_aliases(signatures, kind: str, config: ModelConfig) -> None:
    """The imported signature is the client-facing contract, but the zoo
    forward consumes fixed keys; an alias mismatch would import cleanly and
    then fail every Predict at apply time — fail fast here instead."""
    from ..models.registry import DEFAULT_SIGNATURE, ctr_signatures

    default = signatures.get(DEFAULT_SIGNATURE)
    if default is None:
        return  # no serving_default: caller serves by explicit signature
    # dense_features is intentionally NOT required: the DLRM forward
    # substitutes zeros when it is absent, so sparse-only exports serve fine.
    required = {
        s.name for s in ctr_signatures(config.num_fields)[DEFAULT_SIGNATURE].inputs
    }
    have = {s.name for s in default.inputs}
    missing = required - have
    if missing:
        raise SavedModelImportError(
            f"SavedModel serving_default inputs {sorted(have)} lack the "
            f"{kind!r} forward's required aliases {sorted(missing)}; this "
            "export's request contract does not match the model family "
            "(re-export with matching input names, or extend the importer "
            "with an alias map)"
        )


# The JAX package caches its extractions beside this one
# (dts_tpu_sm_cache_<uid>); a directory of its own keeps the two packages
# from ever writing one file at once.
CACHE_DIR_PREFIX = "dts_tpu_torch_sm_cache_"


def _default_npz_cache_path(saved_model_dir) -> pathlib.Path:
    """Extraction-cache location OUTSIDE the SavedModel directory.

    Serving artifacts are commonly mounted read-only, and writing into the
    artifact both fails there and mutates the export's content/mtimes for
    every other consumer. The cache lives in a per-user temp dir keyed by
    the absolute SavedModel path and a content fingerprint; staleness is
    still governed by _npz_cache_fresh's mtime comparison against the
    export's own files."""
    import hashlib
    import tempfile

    root = pathlib.Path(tempfile.gettempdir()) / f"{CACHE_DIR_PREFIX}{os.getuid()}"
    root.mkdir(mode=0o700, parents=True, exist_ok=True)
    # Fail closed against a pre-created dir in the shared /tmp namespace:
    # mkdir's mode is NOT applied when the dir already exists, and a foreign
    # owner could plant a fresh-mtime npz the importer would np.load as
    # model weights.
    st = root.stat()
    if st.st_uid != os.getuid() or (st.st_mode & 0o077):
        raise SavedModelImportError(
            f"extraction cache dir {root} is not exclusively owned by uid "
            f"{os.getuid()} (uid={st.st_uid}, mode={oct(st.st_mode & 0o777)}); "
            "refusing to trust cached weights from it"
        )
    # Key on path AND a content fingerprint (name/size/mtime of the pb and
    # every variables file): a version dir replaced wholesale (rsync/tar/mv
    # preserving build-time mtimes) must miss the old cache — the mtime-only
    # freshness test cannot see that replacement, a path-only key would
    # silently serve the previous model's weights.
    sm = pathlib.Path(saved_model_dir)
    h = hashlib.sha1(str(sm.resolve()).encode())
    for p in [sm / "saved_model.pb", *sorted((sm / "variables").glob("*"))]:
        try:
            st = p.stat()
            h.update(f"{p.name}:{st.st_size}:{st.st_mtime_ns};".encode())
        except OSError:
            continue
    return root / f"{h.hexdigest()[:24]}.npz"


def graph_cache_path(saved_model_dir) -> pathlib.Path:
    """Where the graph executor's extraction (variables keyed by
    shared_name) of this export is cached."""
    cache = _default_npz_cache_path(saved_model_dir)
    return cache.with_name(cache.stem + "-graph.npz")


def _npz_cache_fresh(saved_model_dir, npz_path) -> bool:
    """The cached extraction is valid only if it postdates every SavedModel
    artifact — an in-place re-export must trigger re-extraction, never serve
    stale weights."""
    npz_path = pathlib.Path(npz_path)
    if not npz_path.exists():
        return False
    cache_mtime = npz_path.stat().st_mtime
    root = pathlib.Path(saved_model_dir)
    # Strict <: a source touched in the same mtime tick as the cache counts
    # as newer (re-extracting costs seconds; stale weights cost correctness).
    sources = [root / "saved_model.pb", *(root / "variables").glob("variables.*")]
    return all(not p.exists() or p.stat().st_mtime < cache_mtime for p in sources)


def _load_npz(path) -> dict[str, np.ndarray]:
    with np.load(path) as npz:
        return {k: npz[k] for k in npz.files}


# ----------------------------------------------------------------- import


def _graph_servable(
    saved_model_dir, meta_graph, signatures, name, version, python, device,
    timings: dict | None = None,
) -> Servable:
    """Servable executing the export's own GraphDef (interop/graph_exec.py).

    Variables are extracted keyed by VarHandleOp shared_name (a separate
    cache from the object-path npz used for zoo binding), and the executor
    is validated with a two-row dry run at import time — an unsupported op
    fails the load with its node name, never a live request.
    """
    from .graph_exec import graph_model

    # ONE signature choice threaded through extraction, executor build, and
    # the dry-run probe (they could otherwise disagree on a multi-signature
    # export, or fail outright on an export without 'serving_default').
    if "serving_default" in meta_graph.signature_def:
        sig_name = "serving_default"
    else:
        served = [
            k for k in meta_graph.signature_def
            if not k.startswith("__")  # skip __saved_model_init_op etc.
        ]
        if not served:
            raise SavedModelImportError(
                f"{saved_model_dir} exports no servable signatures"
            )
        sig_name = sorted(served)[0]

    cache = graph_cache_path(saved_model_dir)
    t0 = time.perf_counter()
    if _npz_cache_fresh(saved_model_dir, cache):
        log.info("reusing extracted graph-variables cache %s", cache)
    else:
        extract_graph_variables(
            saved_model_dir, cache, signature_name=sig_name, python=python
        )
    variables = _load_npz(cache)
    t1 = time.perf_counter()
    _init_device(device)
    tc = time.perf_counter()
    model, params = graph_model(
        meta_graph, variables, signature_name=sig_name, name=name, device=device
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t2 = time.perf_counter()

    from .. import codec as _codec

    sig = signatures[sig_name] if sig_name in signatures else (
        next(iter(signatures.values()))
    )
    # Placeholder shape attrs fill in what the SignatureDef leaves unknown:
    # skipping an unknown-rank input would leave its placeholder unfed and
    # fail the probe for an export the serving path handles fine.
    pnodes = {n.name: n for n in meta_graph.graph_def.node}
    probe = {}
    for spec in sig.inputs:
        shape = spec.shape
        if shape is None:
            node = pnodes.get(model.apply.input_nodes.get(spec.name, ""))
            if node is not None and "shape" in node.attr and not (
                node.attr["shape"].shape.unknown_rank
            ):
                shape = tuple(
                    None if d.size < 0 else d.size
                    for d in node.attr["shape"].shape.dim
                )
            else:
                shape = (None,)  # last resort: a flat 1-D probe
        dims = (2,) + tuple(d or 1 for d in shape[1:]) if shape else (2,)
        probe[spec.name] = np.zeros(dims, _codec.dtype_to_numpy(spec.dtype))
    with torch.inference_mode():
        outputs = model.apply(params, probe)
    if timings is not None:
        timings.update(npz_s=t1 - t0, map_s=0.0, ctx_s=tc - t1, h2d_s=t2 - tc,
                       probe_s=time.perf_counter() - t2)
    log.info(
        "graph executor serves %s: %d variables, outputs %s",
        saved_model_dir, len(params), sorted(outputs),
    )
    return Servable(
        name=name, version=version, model=model, params=params, signatures=signatures
    )


def _init_device(device: torch.device) -> None:
    """Create the device's context before the timed copy, so that `h2d_s`
    times the copy alone: in a fresh process the first device work would
    otherwise pay the CUDA context's start-up."""
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)


def _to_device(tree, template, device: torch.device):
    """The mapped numpy tree as tensors on `device`, each in its template
    leaf's dtype."""
    if isinstance(tree, dict):
        return {k: _to_device(v, template[k], device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, t, device) for v, t in zip(tree, template))
    arr = np.ascontiguousarray(tree)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device=device, dtype=template.dtype)


def import_savedmodel(
    saved_model_dir,
    kind: str,
    config: ModelConfig,
    name: str = "DCN",
    version: int = 1,
    mapping: dict[str, str] | None = None,
    variables_npz=None,
    python: str = sys.executable,
    fallback: bool = True,
    device=None,
    timings: dict | None = None,
) -> Servable:
    """SavedModel directory -> registry-ready Servable, params on `device`
    (default "cuda").

    `kind`/`config` select the model-zoo family the weights belong to (the
    graph itself is not replayed — the zoo's forward, with its fused CUDA
    kernel, is the device program). `kind="graph"` serves the export's own
    GraphDef through the executor instead. `variables_npz` reuses an
    already-extracted dump and skips the TF subprocess. `timings`, when
    given, receives the seconds of each stage: `parse_s` (saved_model.pb),
    `npz_s` (extraction or cache, and np.load), `map_s` (binding), `ctx_s`
    (the device's context, created if this process has none yet) and
    `h2d_s` (the params onto the device).

    The import boundary: when the export's weights do not bind to the
    requested family and `fallback` is on, the importer tries the `generic`
    embed+MLP family with the architecture inferred from the export's own
    shapes, then the GraphDef executor; when all three fail, the error names
    the supported families and each failure reason.
    """
    dev = resolve_device(device)
    t0 = time.perf_counter()
    meta_graph = serve_meta_graph(read_saved_model(saved_model_dir))
    signatures = signatures_from_meta_graph(meta_graph)
    if timings is not None:
        timings["parse_s"] = time.perf_counter() - t0
    if kind == "graph":
        # Explicit graph-executor serving: run the export's own GraphDef
        # (interop/graph_exec.py) instead of binding weights onto a zoo
        # family.
        return _graph_servable(
            saved_model_dir, meta_graph, signatures, name, version, python, dev, timings
        )
    _check_signature_aliases(signatures, kind, config)

    t0 = time.perf_counter()
    if variables_npz is None:
        # Honor a FRESH cache shipped inside the artifact (a deliberate
        # pre-extraction); anything needing (re-)extraction goes to the
        # out-of-artifact default — the artifact dir may be a read-only
        # mount and must never be mutated by the importer.
        in_dir = pathlib.Path(saved_model_dir) / "variables_extracted.npz"
        if in_dir.exists() and _npz_cache_fresh(saved_model_dir, in_dir):
            variables_npz = in_dir
            log.info("reusing extracted variables cache %s", variables_npz)
        else:
            variables_npz = _default_npz_cache_path(saved_model_dir)
            if _npz_cache_fresh(saved_model_dir, variables_npz):
                log.info("reusing extracted variables cache %s", variables_npz)
            else:
                extract_variables(saved_model_dir, variables_npz, python=python)
    variables = _load_npz(variables_npz)
    t1 = time.perf_counter()

    model = build_model(kind, config)
    template = _jax_order(model.shapes())
    try:
        params = map_variables(variables, template, mapping)
    except SavedModelImportError as exc:
        if not fallback or mapping or kind == "generic":
            raise
        try:
            generic_config, generic_mapping = infer_generic_architecture(
                variables, signatures, config
            )
            model = build_model("generic", generic_config)
            template = _jax_order(model.shapes())
            params = map_variables(variables, template, generic_mapping)
        except SavedModelImportError as exc2:
            # Last resort: execute the export's own graph. Slower than a
            # zoo forward (no host fold, transfer compression or fused
            # kernel; raw int64 ids) but serves ANY architecture within the
            # executor's op set.
            try:
                servable = _graph_servable(
                    saved_model_dir, meta_graph, signatures, name, version, python, dev,
                    timings,
                )
            except Exception as exc3:  # noqa: BLE001 — fold into the ranked error
                from ..models.base import model_kinds

                raise SavedModelImportError(
                    f"export at {saved_model_dir} could not be served.\n"
                    f"- as requested kind {kind!r}: {exc}\n"
                    f"- as the generic embed+MLP fallback: {exc2}\n"
                    f"- via the GraphDef executor: {exc3}\n"
                    f"Native families: {sorted(model_kinds())}. Re-export in "
                    "one of these architectures, pass an explicit "
                    "{param-path: variable-name} mapping, or keep the "
                    "export's graph inside the executor's documented op set "
                    "(interop/graph_exec.py)."
                ) from exc
            log.warning(
                "export did not bind to %r (%s) nor the generic fallback "
                "(%s); serving via the GraphDef executor", kind, exc, exc2,
            )
            return servable
        log.warning(
            "export did not bind to %r (%s); serving via the generic "
            "embed+MLP fallback: num_fields=%d embed_dim=%d mlp_dims=%s",
            kind, exc, generic_config.num_fields, generic_config.embed_dim,
            generic_config.mlp_dims,
        )
    t2 = time.perf_counter()
    _init_device(dev)
    tc = time.perf_counter()
    params = _to_device(params, template, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if timings is not None:
        timings.update(npz_s=t1 - t0, map_s=t2 - t1, ctx_s=tc - t2,
                       h2d_s=time.perf_counter() - tc)
    return Servable(
        name=name, version=version, model=model, params=params, signatures=signatures
    )


def main(argv=None) -> None:
    import argparse

    from ..train.checkpoint import save_servable

    parser = argparse.ArgumentParser(
        description="Convert a TF SavedModel into a servable checkpoint of this package"
    )
    parser.add_argument("saved_model_dir")
    parser.add_argument("out_dir")
    parser.add_argument("--kind", default="dcn_v2")
    parser.add_argument("--name", default="DCN")
    parser.add_argument("--version", type=int, default=1)
    parser.add_argument("--num-fields", type=int, default=43)
    parser.add_argument("--vocab-size", type=int, default=1 << 20)
    parser.add_argument("--embed-dim", type=int, default=16)
    parser.add_argument("--mapping", help="JSON file: {param-path: variable-name}")
    parser.add_argument("--device", default="cuda",
                        help="where the import binds the params (default cuda; "
                        "cpu must be asked for)")
    args = parser.parse_args(argv)

    config = ModelConfig(
        name=args.name,
        num_fields=args.num_fields,
        vocab_size=args.vocab_size,
        embed_dim=args.embed_dim,
    )
    mapping = json.loads(pathlib.Path(args.mapping).read_text()) if args.mapping else None
    servable = import_savedmodel(
        args.saved_model_dir, args.kind, config,
        name=args.name, version=args.version, mapping=mapping, device=args.device,
    )
    save_servable(args.out_dir, servable, kind=args.kind)
    print(f"imported {args.name} v{args.version} ({args.kind}) -> {args.out_dir}; "
          f"signatures: {sorted(servable.signatures)}")


if __name__ == "__main__":
    main()
