"""GAN replay buffer (port of `ideal_gan_tpu/data/pool.py`).

Host numpy, as in the JAX package: the pool keeps python state between the
steps, and draws from `np.random.default_rng(seed)` in the JAX pool's
order, so the two pools fed the same items return the same items."""

from __future__ import annotations

import numpy as np


class ItemPool:
    """Keeps up to `pool_size` past generator outputs; once full, each
    incoming item is returned as it is or (probability 1/2) swapped for a
    random stored one. `pool_size` 0 passes every batch through."""

    def __init__(self, pool_size: int = 50, seed: int | None = None):
        self.pool_size = pool_size
        self.items: list[np.ndarray] = []
        self._rng = np.random.default_rng(seed)

    def __call__(self, in_items) -> np.ndarray:
        in_items = np.asarray(in_items)
        if self.pool_size == 0:
            return in_items
        out = []
        for item in in_items:
            if len(self.items) < self.pool_size:
                self.items.append(np.array(item))
                out.append(item)
            elif self._rng.random() > 0.5:
                idx = self._rng.integers(0, len(self.items))
                stored = self.items[idx]
                self.items[idx] = np.array(item)
                out.append(stored)
            else:
                out.append(item)
        return np.stack(out, axis=0)
