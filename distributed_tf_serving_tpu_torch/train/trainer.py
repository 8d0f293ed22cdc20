"""Training loop for the CTR model zoo: torch autograd + torch.optim.

- One eager train step: BCE-with-logits in f32 over the model's logits,
  gradients by autograd through the same compute-dtype forward that
  serving runs (models/*.py), then one AdamW step.
- The optimizer is the JAX package's `optax.adamw(lr)`: b1 0.9, b2 0.999,
  eps 1e-8, and weight decay 1e-4 on every parameter, applied to the
  pre-update value with bias-corrected moments — `torch.optim.AdamW` with
  those settings (its own default decay is 1e-2). Every leaf is updated
  densely, the embedding table included (its gradient is a dense
  scatter-add, as JAX's).
- Updates happen in place (torch.optim), where the JAX step donates the
  old state: `snapshot_params()` returns clones, so a Servable built from
  one does not move when training continues.
- One device. A mesh is not ported yet (ROADMAP.md Queue A item 9) and is
  refused. Entry points run on the card unless the caller asks for the
  CPU (`device="cpu"`, `--device cpu`).

    python -m distributed_tf_serving_tpu_torch.train.trainer --out DIR \
        [--steps 1000] [--batch-size 512] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import native
from ..models.base import Model, resolve_device
from .checkpoint import flatten_params, unflatten_like
from .data import SyntheticCTRConfig, SyntheticCTRStream, auc

# optax.adamw's defaults.
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4

_NO_MESH = ("training over a mesh is not ported yet (ROADMAP.md Queue A item 9); "
            "this package trains on one device")


@dataclasses.dataclass
class TrainState:
    """params: the tree of leaf tensors being trained (requires_grad);
    opt_state: the torch.optim optimizer over those leaves (it holds the
    moments); step: steps taken."""

    params: object
    opt_state: torch.optim.Optimizer
    step: int = 0


def tree_map(fn, tree):
    """`fn` applied to every leaf of a dict / list param tree."""
    return unflatten_like(tree, {k: fn(v) for k, v in flatten_params(tree).items()})


def trainable_copy(params):
    """A deep copy of a param tree whose leaves are fresh tensors that
    require grad (the source is never touched)."""
    return tree_map(lambda t: t.detach().clone().requires_grad_(True), params)


def init_state(params, learning_rate: float) -> TrainState:
    """A TrainState over a trainable copy of `params`, its optimizer
    `optax.adamw(learning_rate)`."""
    params = trainable_copy(params)
    opt = torch.optim.AdamW(list(flatten_params(params).values()), lr=learning_rate,
                            betas=ADAMW_BETAS, eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY)
    return TrainState(params=params, opt_state=opt)


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid cross-entropy in f32, the mean over rows."""
    logits = logits.float()
    labels = labels.float()
    return torch.mean(torch.clamp_min(logits, 0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def make_train_step(model: Model):
    """The (state, batch) -> (state, metrics) step: forward, loss, backward
    and one optimizer step, the state's params updated in place. Metrics
    are 0-d tensors on the params' device (read them with float() when
    needed: each read waits for the device)."""

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            out = model.apply(state.params, batch)
            loss = bce_with_logits(out["logits"], batch["labels"])
            loss.backward()
        opt.step()
        with torch.no_grad():
            accuracy = torch.mean(
                ((torch.sigmoid(out["logits"].float()) > 0.5) == (batch["labels"] > 0.5))
                .float())
        state.step += 1
        return state, {"loss": loss.detach(), "accuracy": accuracy}

    return step


def prepare_batch(raw: dict[str, np.ndarray], vocab_size: int, device) -> dict:
    """A stream batch on `device`: ids folded on the host (int32, the
    serving path's fold), weights and labels float32."""
    out = {
        "feat_ids": torch.from_numpy(native.fold_ids(raw["feat_ids"], vocab_size)),
        "feat_wts": torch.from_numpy(np.ascontiguousarray(raw["feat_wts"], np.float32)),
    }
    if "labels" in raw:
        out["labels"] = torch.from_numpy(np.ascontiguousarray(raw["labels"], np.float32))
    return {k: v.to(device) for k, v in out.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """Synthetic-data training on one device (the CLI's engine)."""

    def __init__(
        self,
        model: Model,
        mesh=None,
        learning_rate: float = 1e-3,
        seed: int = 0,
        tensor_parallel: bool = False,
        stream_config: SyntheticCTRConfig | None = None,
        device=None,
    ):
        if mesh is not None or tensor_parallel:
            raise ValueError(_NO_MESH)
        self.model = model
        self.device = resolve_device(device)
        params = model.init(seed, self.device)
        self.state = init_state(params, learning_rate)
        self.step_fn = make_train_step(model)
        # The default catalog stays within the vocab, so the fold is
        # injective and every id's embedding can learn its teacher weight.
        self.stream = SyntheticCTRStream(
            stream_config
            or SyntheticCTRConfig(
                num_fields=model.config.num_fields,
                id_space=min(1 << 18, model.config.vocab_size),
                seed=seed,
            )
        )

    def snapshot_params(self):
        """Detached clones of the current params: a Servable built from
        them keeps its values while fit() goes on updating the live ones
        in place."""
        return tree_map(lambda t: t.detach().clone(), self.state.params)

    def _prepare(self, batch: dict[str, np.ndarray]) -> dict:
        return prepare_batch(batch, self.model.config.vocab_size, self.device)

    def fit(self, steps: int, batch_size: int = 512, log_every: int = 0,
            auc_every: int = 0) -> dict:
        """Train `steps` steps on stream batches 0..steps-1. auc_every > 0
        records a held-out AUC curve at that cadence (and at the last
        step) under "auc_curve"; eval time is excluded from
        examples_per_s."""
        metrics: dict = {}
        curve: list[list[float]] = []
        eval_wall = 0.0
        t0 = time.perf_counter()
        for i in range(steps):
            batch = self._prepare(self.stream.batch(batch_size, i))
            self.state, metrics = self.step_fn(self.state, batch)
            if log_every and (i + 1) % log_every == 0:
                print(f"step {i + 1}: loss={float(metrics['loss']):.4f}")
            if auc_every and ((i + 1) % auc_every == 0 or i + 1 == steps):
                _sync(self.device)
                te = time.perf_counter()
                curve.append([i + 1, round(self.eval_auc(batches=2, batch_size=batch_size), 4)])
                eval_wall += time.perf_counter() - te
        _sync(self.device)
        wall = time.perf_counter() - t0 - eval_wall
        out = {
            "steps": steps,
            "wall_s": wall,
            "examples_per_s": steps * batch_size / wall,
            **{k: float(v) for k, v in metrics.items()},
        }
        if curve:
            out["auc_curve"] = curve
        return out

    def eval_auc(self, batches: int = 8, batch_size: int = 1024, offset: int = 1_000_000,
                 with_bayes: bool = False):
        """Held-out AUC (stream indices disjoint from training).
        with_bayes=True also returns the teacher's own AUC on the same rows:
        the ceiling the model's number should be read against."""
        scores, labels, teacher = [], [], []
        with torch.no_grad():
            for i in range(batches):
                raw = self.stream.batch(batch_size, offset + i)
                batch = self._prepare(raw)
                out = self.model.apply(self.state.params,
                                       {k: batch[k] for k in ("feat_ids", "feat_wts")})
                scores.append(out["prediction_node"].float().cpu().numpy())
                labels.append(raw["labels"])
                if with_bayes:
                    teacher.append(self.stream._teacher_score(raw["feat_ids"], raw["feat_wts"]))
        labels = np.concatenate(labels)
        model_auc = auc(labels, np.concatenate(scores))
        if with_bayes:
            return model_auc, auc(labels, np.concatenate(teacher))
        return model_auc


def main(argv=None) -> None:
    """Train on the synthetic CTR stream and write a servable checkpoint
    (safetensors + servable.json, manifest last)."""
    import argparse

    from ..models.base import ModelConfig, build_model
    from ..models.registry import Servable, model_signatures
    from .checkpoint import save_servable

    parser = argparse.ArgumentParser(description="Train a CTR model, save a servable")
    parser.add_argument("--out", required=True, help="checkpoint output dir")
    parser.add_argument("--kind", default="dcn_v2")
    parser.add_argument("--name", default="DCN")
    parser.add_argument("--version", type=int, default=1)
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--batch-size", type=int, default=512)
    parser.add_argument("--learning-rate", type=float, default=1e-3)
    parser.add_argument("--num-fields", type=int, default=43)
    parser.add_argument("--vocab-size", type=int, default=1 << 20)
    parser.add_argument("--embed-dim", type=int, default=16)
    parser.add_argument("--mesh-devices", type=int, default=0,
                        help="refused unless 0: " + _NO_MESH)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--id-space", type=int, default=0,
                        help="synthetic catalog size (0 = min(2^18, vocab)); denser catalogs "
                        "give each embedding row more views per step")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' to train on the CPU)")
    args = parser.parse_args(argv)
    if args.mesh_devices:
        parser.error(f"--mesh-devices {args.mesh_devices}: {_NO_MESH}")

    config = ModelConfig(
        name=args.name, num_fields=args.num_fields, vocab_size=args.vocab_size,
        embed_dim=args.embed_dim,
    )
    model = build_model(args.kind, config)
    stream_config = None
    if args.id_space:
        # Clamped to the vocab: past it the fold stops being injective and
        # colliding ids carry contradictory labels.
        id_space = min(args.id_space, args.vocab_size)
        if id_space != args.id_space:
            print(f"--id-space {args.id_space} clamped to vocab size {id_space}")
        stream_config = SyntheticCTRConfig(
            num_fields=args.num_fields, id_space=id_space, seed=args.seed
        )
    trainer = Trainer(model, learning_rate=args.learning_rate, seed=args.seed,
                      stream_config=stream_config, device=args.device)
    metrics = trainer.fit(args.steps, batch_size=args.batch_size,
                          log_every=max(args.steps // 10, 1))
    auc_val, bayes = trainer.eval_auc(with_bayes=True)
    servable = Servable(
        name=args.name, version=args.version, model=model,
        params=trainer.snapshot_params(), signatures=model_signatures(model),
    )
    save_servable(args.out, servable, kind=args.kind)
    print(
        f"trained {args.kind} {args.steps} steps on {trainer.device}: "
        f"loss={metrics['loss']:.4f} auc={auc_val:.4f} bayes_auc={bayes:.4f} "
        f"({metrics['examples_per_s']:.0f} ex/s) -> {args.out}"
    )


if __name__ == "__main__":
    main()
