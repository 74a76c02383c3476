"""retrace-guard violation: a dispatcher whose capture cache keys on the
input's dtype as well as its padded width, so the same width fed as int32
one call and int64 the next captures two graphs."""

import numpy as np


class DtypeKeyedDispatcher:
    def __init__(self):
        self.graphs = {}

    def dispatch(self, sources):
        arr = np.asarray(sources)
        key = (arr.shape, arr.dtype)             # dtype wobble: recaptures
        if key not in self.graphs:
            self.graphs[key] = object()          # a "captured graph"
        return self.graphs[key]


class WidthKeyedDispatcher(DtypeKeyedDispatcher):
    def dispatch(self, sources):
        arr = np.asarray(sources, np.int32)
        return self.graphs.setdefault(arr.shape, object())
