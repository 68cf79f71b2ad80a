"""Training substrate: the AdamW optimizer and the predictor trainer."""
from repro_torch.training.optim import (
    AdamConfig,
    AdamState,
    adam_init,
    adam_update,
    cosine_lr,
    make_train_step,
)
from repro_torch.training.predictor_trainer import (
    COST_TRAIN,
    QUALITY_TRAIN,
    TrainConfig,
    make_ensemble_predictor_step,
    make_masked_predictor_step,
    make_predictor_step,
    train_dual_predictors,
    train_predictor,
)

__all__ = [
    "AdamConfig", "AdamState", "adam_init", "adam_update", "cosine_lr",
    "make_train_step", "COST_TRAIN", "QUALITY_TRAIN", "TrainConfig",
    "make_ensemble_predictor_step", "make_masked_predictor_step",
    "make_predictor_step", "train_dual_predictors", "train_predictor",
]
