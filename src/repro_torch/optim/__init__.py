"""Optimizer, gradient utilities and LR schedules of the train step."""
from repro_torch.optim.adamw import adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.grad import (accumulate_microbatches,  # noqa: F401
                                    clip_by_global_norm, global_norm)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup  # noqa: F401
