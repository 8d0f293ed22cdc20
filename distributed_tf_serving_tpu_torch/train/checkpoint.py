"""Servable checkpointing: params + model metadata on disk, read and written
with numpy and torch alone.

A checkpoint directory holds `params.safetensors` and the JAX package's
`servable.json` manifest (name, version, model kind, ModelConfig), from
which `load_servable` rebuilds a registry-ready Servable. The write order
is the JAX package's commit protocol: params first, the manifest LAST, so
a reader polling a base path (serving/version_watcher.py) never loads a
half-written version.

The params file is in the safetensors format, parsed and written here
(no `safetensors` package): an 8-byte little-endian header length, a JSON
header mapping each tensor name to its `dtype`, `shape` and
`data_offsets` [begin, end) into the buffer that follows (plus an
optional `__metadata__` map of strings), then the raw little-endian
buffer. The header is padded with spaces to a multiple of 8 bytes so the
buffer starts aligned. Tensor names are the param tree's dotted paths:
`embedding`, `cross.0.w`, `mlp.1.b`, `out.w` (for every model family:
`wide_bias`, `temperature` and DeepFM's `bias` are 0-d tensors, shape []).
The manifest's `kind` picks the family; a dlrm servable's signatures take
the optional `dense_features` input.

A JAX-package checkpoint (an Orbax `params/` directory beside the same
manifest) gains its `params.safetensors` from
`tools/jax_checkpoint_to_torch.py`, which runs where JAX is installed.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import struct
import time

import numpy as np
import torch

from ..models.base import ModelConfig, build_model, resolve_device
from ..models.registry import Servable, model_signatures

MANIFEST = "servable.json"
PARAMS_FILE = "params.safetensors"
JAX_PARAMS_DIR = "params"  # the JAX package's Orbax directory

# safetensors dtype name -> (numpy dtype holding the bits, torch dtype).
# bf16 has no numpy dtype: its bits travel as int16 and are viewed as
# torch.bfloat16.
_DTYPES = {
    "F32": (np.dtype("<f4"), torch.float32),
    "BF16": (np.dtype("<i2"), torch.bfloat16),
    "F16": (np.dtype("<f2"), torch.float16),
    "I8": (np.dtype("i1"), torch.int8),
    "I32": (np.dtype("<i4"), torch.int32),
}
_TORCH_TO_NAME = {t: name for name, (_, t) in _DTYPES.items()}
_NUMPY_TO_NAME = {
    np.dtype("float32"): "F32", np.dtype("float16"): "F16",
    np.dtype("int8"): "I8", np.dtype("int32"): "I32",
}


class CheckpointError(ValueError):
    """A params file or manifest that does not match the model it names."""


# ------------------------------------------------------------- param trees


def flatten_params(tree, prefix: str = "") -> dict:
    """{dotted path: leaf} of a dict/list param tree, in tree order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten_params(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def unflatten_like(template, flat: dict, prefix: str = ""):
    """The tree of `template` with each leaf taken from `flat` by its dotted
    path (the caller has checked that the key sets match)."""
    if isinstance(template, dict):
        return {k: unflatten_like(v, flat, f"{prefix}.{k}" if prefix else k)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [unflatten_like(v, flat, f"{prefix}.{i}" if prefix else str(i))
                for i, v in enumerate(template)]
    return flat[prefix]


# ------------------------------------------------------------- safetensors


def _leaf_bytes(name: str, leaf) -> tuple[str, tuple[int, ...], np.ndarray]:
    """(dtype name, shape, C-contiguous little-endian numpy bits) of a torch
    tensor, a leaf placed on a mesh (parallel/sharding.py ShardedLeaf,
    gathered whole) or a numpy array (a numpy bfloat16 array, as the JAX
    package's host restore gives, counts as BF16)."""
    if not isinstance(leaf, torch.Tensor) and hasattr(leaf, "blocks"):
        leaf = leaf.gather("cpu")
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype not in _TORCH_TO_NAME:
            raise CheckpointError(f"{name}: dtype {t.dtype} is not supported")
        dt = _TORCH_TO_NAME[t.dtype]
        bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return dt, tuple(t.shape), bits.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return "BF16", arr.shape, np.ascontiguousarray(arr).view(np.int16)
    if arr.dtype not in _NUMPY_TO_NAME:
        raise CheckpointError(f"{name}: dtype {arr.dtype} is not supported")
    dt = _NUMPY_TO_NAME[arr.dtype]
    return dt, arr.shape, np.ascontiguousarray(arr, dtype=_DTYPES[dt][0])


def save_safetensors(path, tensors: dict, metadata: dict[str, str] | None = None) -> None:
    """Write `tensors` ({name: torch tensor or numpy array}) as one
    safetensors file. Tensors are laid out widest element first, then by
    name, so every tensor starts aligned to its element size."""
    leaves = {name: _leaf_bytes(name, leaf) for name, leaf in tensors.items()}
    order = sorted(leaves, key=lambda k: (-_DTYPES[leaves[k][0]][0].itemsize, k))
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    off = 0
    for name in order:
        dt, shape, bits = leaves[name]
        header[name] = {"dtype": dt, "shape": list(shape),
                        "data_offsets": [off, off + bits.nbytes]}
        off += bits.nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            f.write(leaves[name][2].data)  # the array's own buffer, no copy


def read_header(path) -> tuple[dict, int]:
    """(header, byte offset of the data buffer) of a safetensors file."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise CheckpointError(f"{path}: shorter than a safetensors header")
        (n,) = struct.unpack("<Q", head)
        raw = f.read(n)
    if len(raw) != n:
        raise CheckpointError(f"{path}: header of {n} bytes is truncated")
    try:
        header = json.loads(raw)
    except ValueError as e:
        raise CheckpointError(f"{path}: header is not JSON: {e}") from e
    if not isinstance(header, dict):
        raise CheckpointError(f"{path}: header is not a JSON object")
    return header, 8 + n


def load_safetensors(path, device="cpu") -> dict[str, torch.Tensor]:
    """{name: tensor on `device`} of a safetensors file. The file is
    memory-mapped; each tensor is one copy from the mapping to `device`
    (on the CPU the copy owns its memory, so the file may go away)."""
    header, start = read_header(path)
    header.pop("__metadata__", None)
    # Copy-on-write mapping: writable views, so torch takes them without a
    # warning; nothing writes to them, so no page is ever copied.
    mm = np.memmap(path, dtype=np.uint8, mode="c")
    size = mm.shape[0] - start
    out = {}
    for name, info in header.items():
        try:
            dt, shape, (begin, end) = info["dtype"], tuple(info["shape"]), info["data_offsets"]
        except (KeyError, TypeError, ValueError) as e:
            raise CheckpointError(f"{path}: tensor {name!r}: malformed entry {info!r}") from e
        if dt not in _DTYPES:
            raise CheckpointError(
                f"{path}: tensor {name!r}: dtype {dt!r} is not supported; have {sorted(_DTYPES)}")
        np_dt, torch_dt = _DTYPES[dt]
        nbytes = int(np.prod(shape, dtype=np.int64)) * np_dt.itemsize
        if not 0 <= begin <= end <= size or end - begin != nbytes:
            raise CheckpointError(
                f"{path}: tensor {name!r}: data_offsets [{begin}, {end}) do not hold "
                f"{dt} {list(shape)} in a buffer of {size} bytes")
        bits = mm[start + begin:start + end].view(np_dt).reshape(shape)
        t = torch.from_numpy(bits)
        if torch_dt == torch.bfloat16:
            t = t.view(torch.bfloat16)
        dev = torch.device(device)
        out[name] = t.clone() if dev.type == "cpu" else t.to(dev)
    del mm
    return out


# --------------------------------------------------------------- servables


def save_servable(path, servable: Servable, kind: str) -> None:
    """Write params + manifest. `kind` is the model-zoo family name.

    Params first, manifest LAST: the manifest's existence marks the
    checkpoint complete."""
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    manifest = {
        "name": servable.name,
        "version": servable.version,
        "kind": kind,
        "config": dataclasses.asdict(servable.model.config),
    }
    tmp = path / (PARAMS_FILE + ".tmp")
    save_safetensors(tmp, flatten_params(servable.params))
    os.replace(tmp, path / PARAMS_FILE)
    (path / MANIFEST).write_text(json.dumps(manifest, indent=2))


def read_manifest(path) -> tuple[dict, str, ModelConfig]:
    """(manifest, kind, ModelConfig) of a checkpoint directory."""
    manifest = json.loads((pathlib.Path(path) / MANIFEST).read_text())
    raw = dict(manifest["config"])
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = sorted(set(raw) - fields)
    if unknown:
        raise CheckpointError(f"{path}/{MANIFEST}: config keys this package does not know: "
                              f"{unknown}")
    for key in ("mlp_dims", "bottom_mlp_dims"):
        if key in raw:
            raw[key] = tuple(raw[key])
    return manifest, manifest["kind"], ModelConfig(**raw)


def load_servable(path, mesh=None, tensor_parallel: bool = False, host: bool = False,
                  device=None, timings: dict | None = None) -> Servable:
    """Rebuild a Servable from a checkpoint directory, its params on
    `device` (default "cuda"). Every tensor of the model's param tree must
    be in the file with the tree's dtype and shape, and nothing else.

    With a mesh (parallel/mesh.py) the params come back already placed
    (parallel/sharding.py place_params, the family's partition rules):
    vocab tables split over the model axis, and the dense weights too when
    tensor_parallel, so a ShardedExecutor over that mesh serves them
    without placing them again. host=True gives unplaced CPU tensors (the
    multi-process tier's and the export's read); a mesh with host=True is
    an error, as in the JAX package.

    `timings`, when given, receives `read_s` (header parse and checks) and
    `copy_s` (the mapped file to the device, one copy per tensor)."""
    path = pathlib.Path(path)
    if host:
        if mesh is not None:
            raise ValueError("host=True restores unplaced tensors; mesh is exclusive")
        dev = torch.device("cpu")
    elif mesh is not None:
        dev = mesh.device(0, 0)
    else:
        dev = resolve_device(device)
    manifest, kind, config = read_manifest(path)
    model = build_model(kind, config)
    want = flatten_params(model.shapes())
    t0 = time.perf_counter()
    file = path / PARAMS_FILE
    header, _ = read_header(file)
    header.pop("__metadata__", None)
    missing = sorted(set(want) - set(header))
    extra = sorted(set(header) - set(want))
    if missing or extra:
        raise CheckpointError(
            f"{file}: tensors do not match the {kind} param tree: missing {missing}, "
            f"unexpected {extra}")
    for name, meta in want.items():
        info = header[name]
        if info.get("dtype") != _TORCH_TO_NAME.get(meta.dtype) or \
                tuple(info.get("shape", ())) != tuple(meta.shape):
            raise CheckpointError(
                f"{file}: tensor {name!r} is {info.get('dtype')} {info.get('shape')}; the "
                f"{kind} model wants {_TORCH_TO_NAME.get(meta.dtype)} {list(meta.shape)}")
    t1 = time.perf_counter()
    flat = load_safetensors(file, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if timings is not None:
        timings["read_s"] = t1 - t0
        timings["copy_s"] = time.perf_counter() - t1
    params = unflatten_like(model.shapes(), flat)
    if mesh is not None:
        from ..parallel.sharding import place_params

        params = place_params(params, mesh, tensor_parallel, model_kind=kind)
    return Servable(
        name=manifest["name"],
        version=manifest["version"],
        model=model,
        params=params,
        signatures=model_signatures(model),
    )
