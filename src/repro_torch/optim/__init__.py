from repro_torch.optim import adamw
from repro_torch.optim.adamw import (OptimizerConfig, OptState, clip_by_global_norm,
                                     global_norm, init, lr_at, update)
