from repro_torch.train.loop import Trainer, TrainerConfig  # noqa: F401
from repro_torch.train.steps import make_train_step  # noqa: F401
