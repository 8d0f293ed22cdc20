"""Convert a JAX-package checkpoint directory for the PyTorch port.

    python tools/jax_checkpoint_to_torch.py SRC [DST]

SRC is a directory written by `distributed_tf_serving_tpu.train.checkpoint
.save_servable` (`servable.json` + an Orbax `params/` directory). The tool
restores its params to host numpy arrays and writes them as
`params.safetensors` with the port's own writer
(`distributed_tf_serving_tpu_torch.train.checkpoint.save_safetensors`),
tensor names the param tree's dotted paths (`embedding`, `cross.0.w`, ...).

Without DST the file is added to SRC in place: a version directory under a
`--model-base-path` becomes loadable by the port's version watcher on its
next poll. With DST the file, a copy of SRC's `assets.extra/` (the warmup
requests) when there is one, and then — last, the commit marker — a copy
of `servable.json` go to DST. The params file is written under a temporary
name and renamed into place, so a watcher never sees half a file.

Runs only where JAX and Orbax are installed; the port never imports it.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def convert(src, dst=None) -> pathlib.Path:
    """Write `params.safetensors` for the JAX checkpoint in `src` into `dst`
    (default: `src` itself); returns the directory written."""
    from distributed_tf_serving_tpu.train.checkpoint import MANIFEST, load_servable
    from distributed_tf_serving_tpu_torch.train.checkpoint import (
        PARAMS_FILE,
        flatten_params,
        save_safetensors,
    )

    src = pathlib.Path(src)
    dst = pathlib.Path(dst) if dst is not None else src
    servable = load_servable(src, host=True)
    dst.mkdir(parents=True, exist_ok=True)
    tmp = dst / (PARAMS_FILE + ".tmp")
    save_safetensors(tmp, flatten_params(servable.params))
    os.replace(tmp, dst / PARAMS_FILE)
    if dst.resolve() != src.resolve():
        extra = src / "assets.extra"
        if extra.is_dir():
            shutil.copytree(extra, dst / "assets.extra", dirs_exist_ok=True)
        tmp = dst / (MANIFEST + ".tmp")
        shutil.copyfile(src / MANIFEST, tmp)
        os.replace(tmp, dst / MANIFEST)
    return dst


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", help="JAX checkpoint directory (servable.json + params/)")
    p.add_argument("dst", nargs="?", help="output directory (default: SRC, in place)")
    args = p.parse_args(argv)
    out = convert(args.src, args.dst)
    print(f"wrote {out / 'params.safetensors'}")


if __name__ == "__main__":
    main()
