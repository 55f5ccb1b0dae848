from repro_torch.optim.optimizers import (Optimizer, adamw, apply_updates,  # noqa: F401
                                          clip_by_global_norm, global_norm,
                                          lamb)
from repro_torch.optim.schedules import constant, warmup_cosine, warmup_poly  # noqa: F401
