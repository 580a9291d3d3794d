"""Random hyper-parameter sampling (counterpart of
convnets_tpu/tune/sampler.py, copied: the same np.random.RandomState
draws in the same order, so both packages sample the same values for the
same distributions and seed; the reference's search driver,
mngrtune.py:66, uses sklearn's ParameterSampler).

Each search-space field is either a list (uniform choice) or an object with
.rvs(random_state) (a continuous distribution, settings.Uniform/LogUniform).
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np


class ParameterSampler:
    def __init__(self, distributions: Dict, n_iter: int, seed: int = 0):
        self.distributions = dict(distributions)
        self.n_iter = int(n_iter)
        self.seed = seed

    def __len__(self):
        return self.n_iter

    def __iter__(self) -> Iterator[Dict]:
        rng = np.random.RandomState(self.seed)
        keys = sorted(self.distributions)
        for _ in range(self.n_iter):
            sample = {}
            for k in keys:
                dist = self.distributions[k]
                if hasattr(dist, "rvs"):
                    sample[k] = dist.rvs(rng)
                else:
                    values: List = list(dist)
                    sample[k] = values[rng.randint(len(values))]
            yield sample
