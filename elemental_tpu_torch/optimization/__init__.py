"""Optimization tier (PyTorch port of ``elemental_tpu/optimization``):
Mehrotra IPMs (LP/QP/SOCP, direct and affine forms, dense and sparse),
positive-orthant and second-order-cone utilities, proximal operators,
equilibration and the models.

Reference: Elemental ``src/optimization/{solvers,util,prox,models}/**``.
"""
from .util import MehrotraCtrl, max_step, num_outside, safe_div
from .lp import lp
from .qp import qp
from .soc import (socp, make_cone_layout, soc_dets, soc_apply, soc_inverse,
                  soc_sqrt, soc_identity, soc_max_step, soc_nesterov_todd)
from .prox import (soft_threshold, svt, clip, frobenius_prox,
                   hinge_loss_prox, logistic_prox)
from .models import (bp, lav, nnls, lasso, svm, rpca, cp, ds,
                     en, nmf, sparse_inv_cov,
                     long_only_portfolio, tv)
from .equilibrate import (ruiz_equil, geom_equil, symmetric_ruiz_equil,
                          row_col_maxabs)
from .affine import lp_affine, qp_affine, socp_affine, ruiz_equil_stacked
from .sparse_ipm import (lp_sparse, lav_sparse, bp_sparse,
                         sparse_ruiz_equil, sparse_to_coo)
