"""bare-time violations: draws from torch's global generator (no
``generator=``), beside seeded draws, which are fine."""

import numpy as np
import torch


def init_weights(shape, gen):
    torch.manual_seed(0)                         # [viol:manual-seed]
    w = torch.randn(shape)                       # [viol:randn]
    b = torch.empty(shape[-1]).uniform_(-1, 1)   # [viol:uniform]
    ok = torch.randn(shape, generator=gen)
    ok_fill = torch.empty(shape[-1]).uniform_(-1, 1, generator=gen)
    host = np.random.default_rng(0).random(shape)
    return w, b, ok, ok_fill, host
