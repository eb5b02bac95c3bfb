"""Episodic (meta-learning) samplers: N-way k-shot tasks (paper §II-A),
the port's copy of ``repro/data/episodic.py`` (numpy only).

Meta-train / meta-test splits partition *classes* (Fig. 2c).  Episodes are
deterministic in (seed, episode index) so runs are reproducible and
resumable.
"""

from __future__ import annotations

import numpy as np


class EpisodicSampler:
    def __init__(self, dataset, class_ids, seed: int = 0):
        self.ds = dataset
        self.class_ids = np.asarray(class_ids)
        self.seed = seed

    def episode(self, ep: int, n_ways: int, k_shots: int, n_query: int):
        """Returns (support_x, support_y, query_x, query_y); y in [0, n_ways)."""
        rng = np.random.default_rng((self.seed, ep))
        ways = rng.choice(self.class_ids, size=n_ways, replace=False)
        sx, sy, qx, qy = [], [], [], []
        for j, cls in enumerate(ways):
            samples = self.ds.sample(int(cls), k_shots + n_query, seed=ep * 131 + j)
            sx.append(samples[:k_shots])
            qx.append(samples[k_shots:])
            sy.append(np.full(k_shots, j, np.int32))
            qy.append(np.full(n_query, j, np.int32))
        return (np.concatenate(sx), np.concatenate(sy),
                np.concatenate(qx), np.concatenate(qy))


def split_classes(n_classes: int, train_frac: float = 0.7, seed: int = 0):
    """Meta-train / meta-test class split (disjoint classes, Fig. 2c)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_classes)
    cut = int(n_classes * train_frac)
    return perm[:cut], perm[cut:]
