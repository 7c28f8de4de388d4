from .optimizers import (OptState, Optimizer, adamw, clip_by_global_norm,
                         cosine_schedule, linear_warmup_cosine, sgd)
