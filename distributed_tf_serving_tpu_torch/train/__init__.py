"""Training: the torch trainer, synthetic CTR data, servable checkpoints,
and the fine-tune publisher."""

from .checkpoint import load_servable, save_servable
from .data import SyntheticCTRConfig, SyntheticCTRStream, auc
from .publisher import fine_tune, publish_finetuned
from .trainer import Trainer, TrainState, bce_with_logits, make_train_step

__all__ = [
    "Trainer",
    "TrainState",
    "make_train_step",
    "bce_with_logits",
    "SyntheticCTRStream",
    "SyntheticCTRConfig",
    "auc",
    "save_servable",
    "load_servable",
    "fine_tune",
    "publish_finetuned",
]
