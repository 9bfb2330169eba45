"""Training of the port: the train state (:mod:`.state`), the eager train
and eval steps (:mod:`.step`), atomic async checkpoints
(:mod:`.checkpoint`), the fault-tolerant loop (:mod:`.trainer`) and QAT
of the paper's CIFAR networks (:mod:`.cifar_qat`)."""
from .state import TrainState, init_train_state, state_template
from .step import build_eval_step, build_train_step

__all__ = ["TrainState", "init_train_state", "state_template",
           "build_eval_step", "build_train_step"]
