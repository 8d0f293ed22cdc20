"""Export a servable checkpoint as a TensorFlow SavedModel, and publish
artifacts into a TF-Serving versioned base path.

`export_servable` takes a trained checkpoint (train/checkpoint.py) out to
consumers still running `tensorflow_model_server`. The JAX package goes
out through jax2tf (an `XlaCallModule` op); torch has no counterpart, so
the family's forward is written here in plain TF ops, with the port's
numerics: operands rounded to the compute dtype where the port rounds
them (models/*.py), f32 products and accumulation. The artifact carries
the reference serving contract (`feat_ids` DT_INT64 + `feat_wts`
DT_FLOAT [n, F] -> `prediction_node`, DCNClient.java:98-108; dlrm adds
`dense_features` [n, dense]), with the vocab fold in TF ops (`floormod`,
the host fold's exact mod) so int64 ids past 2^31 survive as they do in
the port. Weights are ordinary tf.Variables, so the artifact has the
standard `variables/` TensorBundle layout, and, the graph being plain TF
ops, the port's own `--savedmodel` import (interop/graph_exec.py) serves
it too.

The export process imports TensorFlow first and must never load the
port's vendored protos: their tensorflow.* descriptors collide with TF's
in the process-wide pool. It reads the checkpoint through
train/checkpoint.py, whose import chain (models/, train/) holds no proto;
the warmup record, which needs the protos, is written by a TF-free
subprocess (`_write_warmup_assets`). TensorFlow is a CPU-side dependency:
the card's machine has none.

    python -m distributed_tf_serving_tpu_torch.interop.export \\
        --checkpoint DIR --out DIR [--no-validate]

`publish_version` lands one artifact in `<base>/<N>` atomically, under
the next version number the version watcher's own scanner
(serving/version_watcher.py scan_versions) leaves free; `publish_export`
is the export through it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

# The validation's bound: scores are sigmoid outputs in (0, 1), held
# absolutely, the JAX export's bound and its tests'.
MAX_ABS_ERR_BOUND = 1e-5


def publish_version(base_dir, write_fn, at_least: int = 1,
                    max_attempts: int = 10) -> tuple[int, str]:
    """Write an artifact with `write_fn(tmp_dir)` into a dot-prefixed
    sibling directory (not numeric, so a watcher's scan never lists it),
    then rename it to `<base>/<N>`, N = max(existing numeric versions,
    at_least - 1) + 1. A watcher therefore never sees a half-written
    version. A publisher racing for the same number loses the rename (onto
    a non-empty directory it raises rather than merging), scans again and
    retries under the next number with the artifact already written; the
    directory number is authoritative. Returns (version, path)."""
    # Imported here: the serving package pulls the vendored protos, and an
    # export process (TensorFlow loaded) imports this module.
    from ..serving.version_watcher import scan_versions

    base = os.path.abspath(str(base_dir))
    os.makedirs(base, exist_ok=True)
    tmp = os.path.join(base, f".tmp-publish-{os.getpid()}-{id(write_fn):x}")
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        write_fn(tmp)
        if not os.path.isdir(tmp):
            raise RuntimeError(f"publish writer did not create the artifact dir {tmp}")
        last_exc: OSError | None = None
        for _ in range(max_attempts):
            version = max(list(scan_versions(base)) + [int(at_least) - 1]) + 1
            dst = os.path.join(base, str(version))
            try:
                os.rename(tmp, dst)
            except OSError as exc:
                # Only a destination that now exists is a collision; any
                # other failure (EXDEV, EACCES) surfaces.
                if not os.path.isdir(dst):
                    raise
                last_exc = exc
                continue
            return version, dst
        raise RuntimeError(
            f"could not allocate a version under {base} after {max_attempts} collisions"
        ) from last_exc
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def publish_export(base_dir, checkpoint_dir, validate: bool = True, at_least: int = 1) -> dict:
    """export_servable into the next numeric version slot under `base_dir`.
    The export runs in a subprocess of its own (this module's CLI), so the
    caller's process may hold the port's protos (a server, the lifecycle
    publisher) where the JAX package's needs TensorFlow in-process. The
    export's own validate-then-commit runs inside the publish temp dir, so
    the rename into the numbered slot stays the single commit point."""
    summary: dict = {}

    def write(tmp_dir: str) -> None:
        cmd = [sys.executable, "-m", "distributed_tf_serving_tpu_torch.interop.export",
               "--checkpoint", str(checkpoint_dir), "--out", tmp_dir]
        if not validate:
            cmd.append("--no-validate")
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            raise RuntimeError(f"export of {checkpoint_dir} failed: {r.stderr[-2000:]}")
        summary.update(json.loads(r.stdout.strip().splitlines()[-1]))

    version, path = publish_version(base_dir, write, at_least=at_least)
    summary.update({"version": version, "path": path})
    return summary


# --------------------------------------------------------- the TF forward


def _tf_forward(tf, kind: str, config, params: dict, dense_dim: int | None):
    """fn(p, feat_ids int64, feat_wts, dense_features=None) -> scores: the
    port's forward of `kind` (models/*.py) in TF ops over the dict `p` of
    f32 tensors keyed by dotted param path."""
    import numpy as np

    f32 = tf.float32
    cd = tf.bfloat16 if config.compute_dtype == "bfloat16" else f32
    vocab = config.vocab_size
    F, D = config.num_fields, config.embed_dim
    d = F * D

    def r(x):
        """x rounded to the compute dtype, carried in f32."""
        return x if cd == f32 else tf.cast(tf.cast(x, cd), f32)

    def n_layers(prefix: str) -> int:
        return len({k.split(".")[1] for k in params if k.startswith(prefix + ".")})

    def dense(p, name, x):
        return tf.matmul(r(x), r(p[f"{name}.w"])) + p[f"{name}.b"]

    def mlp(p, name, x, final_relu=True):
        n = n_layers(name)
        for i in range(n):
            x = dense(p, f"{name}.{i}", x)
            if final_relu or i + 1 < n:
                x = tf.nn.relu(x)
        return x

    def embed(p, ids, wts):
        # models/embeddings.py field_embed: the row and the weight rounded
        # to the compute dtype, their product rounded again ([n, F, D]).
        return r(r(tf.gather(p["embedding"], ids)) * r(wts)[..., None])

    def sparse_linear(table, ids, wts):
        return tf.reduce_sum(tf.gather(table, ids) * wts, axis=-1)

    def cross(p, x0):
        x = x0
        for i in range(n_layers("cross")):
            w, b = p[f"cross.{i}.w"], p[f"cross.{i}.b"]
            if kind == "dcn_v2":
                xw = tf.matmul(x, r(w))
                x = r(x0 * (xw + b) + x)
            else:
                xw = tf.reduce_sum(x * r(w), axis=-1, keepdims=True)
                x = r(x0 * xw + b + x)
        return x

    def forward(p, feat_ids, feat_wts, dense_features=None):
        ids = tf.math.floormod(feat_ids, tf.constant(vocab, tf.int64))
        wts = feat_wts
        if kind in ("dcn", "dcn_v2"):
            emb = embed(p, ids, wts)
            x0 = tf.reshape(emb, [-1, d])
            xd = mlp(p, "mlp", x0)
            logit = dense(p, "out", tf.concat([cross(p, x0), xd], axis=-1))[:, 0]
        elif kind == "generic":
            h = tf.reshape(embed(p, ids, wts), [-1, d])
            if n_layers("mlp"):
                h = mlp(p, "mlp", h)
            logit = dense(p, "out", h)[:, 0]
        elif kind == "wide_deep":
            wide = sparse_linear(p["wide"], ids, wts) + p["wide_bias"]
            xd = mlp(p, "mlp", tf.reshape(embed(p, ids, wts), [-1, d]))
            logit = dense(p, "out", xd)[:, 0] + wide
        elif kind == "deepfm":
            first = sparse_linear(p["linear"], ids, wts)
            e = embed(p, ids, wts)
            second = 0.5 * tf.reduce_sum(tf.square(tf.reduce_sum(e, axis=1))
                                         - tf.reduce_sum(tf.square(e), axis=1), axis=-1)
            h = mlp(p, "mlp", tf.reshape(e, [-1, d]))
            logit = first + second + dense(p, "out", h)[:, 0] + p["bias"]
        elif kind == "two_tower":
            nu = config.num_user_fields
            e = embed(p, ids, wts)

            def tower(name, x, fields):
                x = mlp(p, name, tf.reshape(x, [-1, fields * D]), final_relu=False)
                return x / (tf.sqrt(tf.reduce_sum(tf.square(x), axis=-1, keepdims=True))
                            + 1e-12)

            u = tower("user_mlp", e[:, :nu], nu)
            v = tower("item_mlp", e[:, nu:], F - nu)
            logit = tf.reduce_sum(u * v, axis=-1) * p["temperature"]
        elif kind == "dlrm":
            num_feat = F + 1
            bot = mlp(p, "bottom_mlp", dense_features)
            z = tf.concat([r(bot)[:, None, :], embed(p, ids, wts)], axis=1)
            zzt = tf.matmul(z, z, transpose_b=True)
            iu, ju = np.triu_indices(num_feat, k=1)
            inter = tf.gather(tf.reshape(zzt, [-1, num_feat * num_feat]),
                              tf.constant(iu * num_feat + ju, tf.int64), axis=1)
            top = tf.concat([bot, inter], axis=-1)
            logit = dense(p, "out", mlp(p, "top_mlp", top))[:, 0]
        else:
            raise NotImplementedError(f"export has no TF forward for model kind {kind!r}")
        return tf.sigmoid(logit)

    return forward


def export_servable(checkpoint_dir, out_dir, validate: bool = True) -> dict:
    """Convert the checkpointed servable to a SavedModel at `out_dir`.

    Returns a summary dict (model, kind, version, param leaves, and with
    validate the TF-reloaded artifact's max abs error against the port's
    forward on the CPU). Supports the 2-input CTR contract and the 3-input
    dense_features (dlrm) contract of a zoo servable with the host id
    fold; anything else raises, as in the JAX package."""
    if "tensorflow" not in sys.modules:
        # TensorFlow's TFLite helpers import jax where it is installed (an
        # optional import behind a try); the port never loads jax, so it is
        # kept out of this process before TensorFlow starts.
        sys.modules.setdefault("jax", None)
    import tensorflow as tf  # before anything that could load a proto
    import numpy as np
    import torch

    from .. import native
    from ..train.checkpoint import flatten_params, load_servable

    out_dir = str(out_dir)
    servable = load_servable(checkpoint_dir, host=True)
    model = servable.model
    config = model.config
    sig = servable.signature("")
    input_names = sorted(s.name for s in sig.inputs)
    dense_dim = None
    if input_names == ["dense_features", "feat_ids", "feat_wts"]:
        dense_spec = sig.input_specs["dense_features"]
        dense_dim = dense_spec.shape[1] if dense_spec.shape else None
        if not dense_dim or dense_dim < 0:
            # A declared-but-unknown dense width fails rather than ship a
            # 2-input artifact: dlrm substitutes zeros for a missing dense
            # input, so validation alone would never catch the drop.
            raise NotImplementedError(
                "dense_features with unknown width cannot be exported "
                f"(signature shape {dense_spec.shape}); re-save the servable with a "
                "concrete num_dense_features")
    elif input_names != ["feat_ids", "feat_wts"]:
        raise NotImplementedError(
            "export supports the CTR contracts (2-input, or 3-input with dense_features); "
            f"servable declares {input_names}")
    if not model.folds_ids_on_host:
        raise NotImplementedError("export requires a zoo servable with the host id fold contract")
    F = config.num_fields
    flat = {k: v.detach().float().numpy() for k, v in flatten_params(servable.params).items()}
    forward = _tf_forward(tf, model.kind, config, flat, dense_dim)

    class ExportedCTR(tf.Module):
        pass

    module = ExportedCTR()
    # One tf.Variable per leaf, named by its param path: the standard
    # variables/ layout, and names the graph importer binds by.
    module.params = {k: tf.Variable(v, name=k.replace(".", "/")) for k, v in flat.items()}
    specs = [tf.TensorSpec([None, F], tf.int64, name="feat_ids"),
             tf.TensorSpec([None, F], tf.float32, name="feat_wts")]
    if dense_dim is not None:
        specs.append(tf.TensorSpec([None, dense_dim], tf.float32, name="dense_features"))

    def read():
        return {k: v.read_value() for k, v in module.params.items()}

    if dense_dim is None:
        @tf.function(input_signature=specs)
        def serve(feat_ids, feat_wts):
            return {"prediction_node": forward(read(), feat_ids, feat_wts)}
    else:
        @tf.function(input_signature=specs)
        def serve(feat_ids, feat_wts, dense_features):
            return {"prediction_node": forward(read(), feat_ids, feat_wts, dense_features)}

    module.serve = serve
    # Validate-then-commit: written to a sibling temp dir, validated
    # through TF from there, and renamed into place only when it passes, so
    # a watcher on the output's base path never sees a diverged model.
    tmp_dir = out_dir.rstrip("/") + f".tmp-export-{os.getpid()}"
    shutil.rmtree(tmp_dir, ignore_errors=True)
    try:
        tf.saved_model.save(module, tmp_dir, signatures={"serving_default": serve})
        _write_warmup_assets(tmp_dir, servable.name, F, dense_dim)
        summary = {
            "out": out_dir,
            "model": servable.name,
            "kind": model.kind,
            "version": servable.version,
            "num_fields": F,
            "vocab_size": config.vocab_size,
            "param_leaves": len(flat),
        }
        if validate:
            # Reload through TF and score ids past 2^31 against the port's
            # own forward on the CPU (its host fold included).
            rng = np.random.RandomState(7)
            ids = rng.randint(0, 1 << 40, size=(16, F)).astype(np.int64)
            wts = rng.rand(16, F).astype(np.float32)
            feeds = {"feat_ids": tf.constant(ids), "feat_wts": tf.constant(wts)}
            batch = {"feat_ids": torch.from_numpy(native.fold_ids(ids, config.vocab_size)),
                     "feat_wts": torch.from_numpy(wts)}
            if dense_dim is not None:
                dense = rng.rand(16, dense_dim).astype(np.float32)
                feeds["dense_features"] = tf.constant(dense)
                batch["dense_features"] = torch.from_numpy(dense)
            reloaded = tf.saved_model.load(tmp_dir).signatures["serving_default"]
            got = reloaded(**feeds)["prediction_node"].numpy()
            with torch.no_grad():
                want = model.apply(servable.params, batch)["prediction_node"].float().numpy()
            err = float(np.max(np.abs(got - want)))
            if not err < MAX_ABS_ERR_BOUND:
                raise RuntimeError(
                    f"exported SavedModel diverges from the port's forward (max abs err "
                    f"{err:.3e} >= {MAX_ABS_ERR_BOUND})")
            summary["validated"] = True
            summary["max_abs_err"] = err
        shutil.rmtree(out_dir, ignore_errors=True)
        os.replace(tmp_dir, out_dir)
    except BaseException:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        raise
    return summary


def _write_warmup_assets(artifact_dir: str, model_name: str, num_fields: int,
                         dense_dim: int | None) -> None:
    """Give the artifact TF-Serving's warmup convention: one representative
    PredictRequest in assets.extra/tf_serving_warmup_requests, so
    tensorflow_model_server (and the port's version watcher) warm the
    signature at load. Written by a TF-free subprocess: the PredictionLog
    record needs the port's vendored protos, which cannot share this
    process's descriptor pool with TensorFlow."""
    import numpy as np

    rng = np.random.RandomState(11)
    warm = {
        "feat_ids": rng.randint(0, 1 << 40, size=(16, num_fields)).astype(np.int64),
        "feat_wts": rng.rand(16, num_fields).astype(np.float32),
    }
    if dense_dim is not None:
        warm["dense_features"] = rng.rand(16, dense_dim).astype(np.float32)
    extra_dir = os.path.join(artifact_dir, "assets.extra")
    os.makedirs(extra_dir, exist_ok=True)
    npz = os.path.join(extra_dir, "_warm_inputs.npz")
    np.savez(npz, **warm)
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    try:
        subprocess.run(
            [sys.executable, "-c", (
                "import sys, numpy as np\n"
                "from distributed_tf_serving_tpu_torch.serving.warmup import (\n"
                "    make_warmup_record, write_tfrecords)\n"
                "arrays = dict(np.load(sys.argv[1]))\n"
                "write_tfrecords(sys.argv[2], [make_warmup_record(arrays, sys.argv[3])])\n"
            ), npz, os.path.join(extra_dir, "tf_serving_warmup_requests"), model_name],
            check=True, capture_output=True, text=True, timeout=300, env=env,
        )
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"warmup-asset writer failed: {e.stderr[-1000:]}") from e
    finally:
        os.remove(npz)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Export a servable checkpoint as a TF SavedModel")
    parser.add_argument("--checkpoint", required=True,
                        help="servable checkpoint dir (train.save_servable)")
    parser.add_argument("--out", required=True, help="SavedModel output dir")
    parser.add_argument("--no-validate", action="store_true")
    args = parser.parse_args(argv)
    summary = export_servable(args.checkpoint, args.out, validate=not args.no_validate)
    print(json.dumps(summary))


if __name__ == "__main__":
    sys.exit(main())
