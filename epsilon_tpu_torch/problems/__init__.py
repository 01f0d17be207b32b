"""Problem library of the port: the 27 convex-programming benchmark
generators (counterpart of ``epsilon_tpu/problems``), the benchmark
harness (``benchmark``) and the consensus scaling benchmark
(``scaling_bench``)."""

from . import (basis_pursuit, chebyshev, covsel, fused_lasso, group_lasso,  # noqa: F401
               hinge, hinge_l1, hinge_l2, huber, infinite_push, lasso,
               least_abs_dev, logreg_l1, lp, max_gaussian, max_softmax,
               mnist, mv_lasso, oneclass_svm, portfolio, qp, quantile,
               robust_pca, robust_svm, sparse_lasso, tv_1d, tv_denoise)
