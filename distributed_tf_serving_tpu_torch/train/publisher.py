"""Online fine-tune publisher: the train-side leg of the lifecycle plane
(serving/lifecycle.py).

`fine_tune` continues training FROM a serving servable's current params
(never from a fresh init: freshness carries the last version's knowledge
forward) on fresh labeled rows, with the trainer's own step
(train/trainer.py make_train_step). `publish_finetuned` commits the result
atomically into a watched base path (interop/export.py publish_version +
train/checkpoint.py save_servable, manifest last), so a serving process's
version watcher hot-loads it as the next numeric version with no
coordination beyond the filesystem.

The default data source is the synthetic CTR stream; embedded callers pass
`data_fn(step) -> batch` to train on real feedback.
"""

from __future__ import annotations

import dataclasses
import time

import torch


def fine_tune(
    servable,
    steps: int = 200,
    batch_size: int = 256,
    learning_rate: float = 1e-4,
    seed: int = 0,
    stream_config=None,
    data_fn=None,
):
    """Continue training `servable`'s params for `steps` on their device;
    returns (new_params, metrics). The training runs on a deep copy: the
    serving registry keeps handing out the originals while it runs, and
    they never change. The new params are detached and complete (the
    device synchronized) when this returns."""
    from .checkpoint import flatten_params
    from .data import SyntheticCTRConfig, SyntheticCTRStream
    from .trainer import init_state, make_train_step, prepare_batch, tree_map

    model = servable.model
    state = init_state(servable.params, learning_rate)
    device = next(iter(flatten_params(state.params).values())).device
    step_fn = make_train_step(model)
    if data_fn is None:
        stream = SyntheticCTRStream(
            stream_config
            or SyntheticCTRConfig(
                num_fields=model.config.num_fields,
                id_space=min(1 << 18, model.config.vocab_size),
                seed=seed,
            )
        )
        # Offset the stream per seed, so successive publish rounds train
        # on fresh rows, not a replay of the last round's batches.
        base = (seed + 1) * 1_000_000

        def data_fn(i, _stream=stream, _base=base):  # noqa: A001
            return _stream.batch(batch_size, _base + i)

    metrics: dict = {}
    t0 = time.perf_counter()
    for i in range(steps):
        batch = prepare_batch(data_fn(i), model.config.vocab_size, device)
        state, metrics = step_fn(state, batch)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return tree_map(lambda t: t.detach(), state.params), {
        "steps": steps,
        "wall_s": round(time.perf_counter() - t0, 3),
        **{k: float(v) for k, v in metrics.items()},
    }


def publish_finetuned(
    base_dir,
    servable,
    kind: str,
    steps: int = 200,
    batch_size: int = 256,
    learning_rate: float = 1e-4,
    seed: int = 0,
    stream_config=None,
    data_fn=None,
) -> dict:
    """fine_tune + an atomic publish into the watched base dir as the next
    numeric version. The manifest records a best-guess version number; the
    directory number allocated at commit is authoritative (the version
    watcher's loader contract). Returns {version, path, steps, wall_s,
    loss, accuracy}."""
    from ..interop.export import publish_version
    from .checkpoint import save_servable

    new_params, metrics = fine_tune(
        servable,
        steps=steps,
        batch_size=batch_size,
        learning_rate=learning_rate,
        seed=seed,
        stream_config=stream_config,
        data_fn=data_fn,
    )

    def write(tmp_dir: str) -> None:
        save_servable(
            tmp_dir,
            dataclasses.replace(servable, params=new_params, version=servable.version + 1),
            kind=kind,
        )

    version, path = publish_version(base_dir, write, at_least=servable.version + 1)
    return {"version": version, "path": path, **metrics}
