from gluon_e2e_asr.training.train_step import (
    TrainState,
    create_train_state,
    make_train_step,
    make_optimizer,
)
from gluon_e2e_asr.training.checkpoint import (
    save_checkpoint,
    restore_checkpoint,
    latest_checkpoint,
)
from gluon_e2e_asr.training.trainer import Trainer
