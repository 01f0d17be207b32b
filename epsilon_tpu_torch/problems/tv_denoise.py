"""2-D (color) total-variation denoising (``problems/tv_denoise.py``).

The reference loads a JPEG; here the image is synthesized (piecewise-
constant blocks + noise) so the generator has no data dependencies.
"""

import numpy as np

import epsilon_tpu_torch as ep


def _synthetic_image(n):
    rng = np.random.RandomState(0)
    img = np.zeros((n, n, 3))
    for _ in range(6):
        i0, j0 = rng.randint(0, n, 2)
        di, dj = rng.randint(max(n // 4, 1), n, 2)
        img[i0:i0 + di, j0:j0 + dj, :] += rng.rand(3)
    img += 0.1 * rng.randn(n, n, 3)
    return img


def create(n, lam):
    Y = _synthetic_image(n)
    X = [ep.Variable(n, n) for _ in range(3)]
    f = ep.sum_squares(X[0] - Y[:, :, 0])
    for i in (1, 2):
        f = f + ep.sum_squares(X[i] - Y[:, :, i])
    f = f + lam * ep.tv2(*X)
    return ep.Problem(ep.Minimize(f))
