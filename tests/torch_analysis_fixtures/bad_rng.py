"""rng-discipline + bare-time violations in the port's spellings: a
builder that reuses a mutable key chain (split stored into state), folds
in data-dependent values, and stamps wall-clock time into build artifacts;
beside a fold over a positional range of steps, which is fine."""

import time

import torch

from repro_torch import rng


class StatefulBuilder:
    def __init__(self, seed: int):
        self.key = rng.prng_key(seed)

    def next_key(self):
        # resume after chunk 7 replays a DIFFERENT key than the original
        # run saw — bitwise resume/repair silently breaks
        self.key, sub = rng.split(self.key)      # [viol:split-state]
        return sub

    def chunk_key(self, ids):
        return rng.fold_in(self.key, ids.sum())  # [viol:fold-data]

    def step_keys(self, t0, steps):
        return rng.fold_in(self.key, torch.arange(t0, t0 + steps))

    def stamp(self):
        return time.time()                       # [viol:bare-time]
