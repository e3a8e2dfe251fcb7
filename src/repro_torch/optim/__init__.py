from repro_torch.optim.optimizers import adafactor, adamw, global_norm, make_optimizer
from repro_torch.optim.schedules import constant, cosine, wsd

__all__ = ["adamw", "adafactor", "global_norm", "make_optimizer", "wsd", "cosine",
           "constant"]
