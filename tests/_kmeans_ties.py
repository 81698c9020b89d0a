"""Planted ties for the K-Means assignment (K2) tests, in numpy."""

import numpy as np


def planted_ties(n, k, d, width, seed=0):
    """Small-integer points and centroids, so that every distance is exact in
    f32; each k-slice's first centroid copied to the end of the slice before
    it (equal distances across a slice boundary) and to the last centroid;
    every third point a copy of a centroid (an exact hit, distance 0, tied
    with that centroid's copies).  Returns float32 (x, c)."""
    rng = np.random.default_rng(seed)
    c = rng.integers(-3, 4, (k, d)).astype(np.float32)
    for k0 in range(width, k, width):
        c[k0 - 1] = c[k0]
    c[-1] = c[0]
    x = rng.integers(-3, 4, (n, d)).astype(np.float32)
    x[::3] = c[rng.integers(0, k, x[::3].shape[0])]
    return x, c
