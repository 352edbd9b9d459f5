from diner_tpu_torch.train.loop import MetricLogger, train
from diner_tpu_torch.train.state import TrainState, create_train_state
from diner_tpu_torch.train.step import eval_step, train_step

__all__ = ["MetricLogger", "TrainState", "create_train_state", "eval_step",
           "train", "train_step"]
