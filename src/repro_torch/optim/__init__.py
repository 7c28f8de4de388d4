from .optimizers import (OptState, Optimizer, adafactor, adamw,
                         clip_by_global_norm, cosine_schedule,
                         distinct_storage, linear_warmup_cosine, sgd)
