"""DataFeeder (counterpart of ``paddle_tpu/fluid/data_feeder.py``):
a minibatch of rows, each a tuple with one value per feed var, becomes
a feed dict of stacked numpy arrays.  Ragged data is padded upstream,
as in the reference."""
from __future__ import annotations

import numpy as np


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None):
        self.feed_names = [v if isinstance(v, str) else v.name
                           for v in feed_list]
        self.feed_vars = feed_list

    def feed(self, iterable):
        rows = list(iterable)
        return {name: np.stack([np.asarray(row[i]) for row in rows])
                for i, name in enumerate(self.feed_names)}
