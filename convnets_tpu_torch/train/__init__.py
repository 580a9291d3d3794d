from convnets_tpu_torch.train.checkpoint import load_jax_checkpoint  # noqa: F401
from convnets_tpu_torch.train.engine import (  # noqa: F401
    Trainer, build_eval_step, build_train_step,
)
from convnets_tpu_torch.train.state import TrainState, create_train_state  # noqa: F401
from convnets_tpu_torch.train.scheduler import ReduceLROnPlateau, StepDecay  # noqa: F401
from convnets_tpu_torch.train import checkpoint, metrics, optim  # noqa: F401
