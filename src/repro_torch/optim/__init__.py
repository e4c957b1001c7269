from repro_torch.optim.adamw import (AdamWState, adamw, clip_by_global_norm,
                                     global_norm)
from repro_torch.optim.schedules import warmup_cosine
