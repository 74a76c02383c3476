"""Training substrate: optimizer, train-step factory (compression lives in
:mod:`repro_torch.distributed.compression`)."""

from repro_torch.training.optimizer import AdamState, AdamWConfig  # noqa: F401
from repro_torch.training.train_loop import init_state, make_train_step  # noqa: F401
