"""Matrix gallery (Elemental ``src/matrices/``): the basic constructors
and the deterministic and random generators."""
from .basic import (
    zeros, ones, identity, hilbert, lehmer, minij,
    uniform, gaussian, hermitian_uniform_spectrum,
)
from .gallery import (
    fourier, toeplitz, hankel, circulant, cauchy, walsh, wilkinson,
    laplacian_1d, laplacian_2d, jordan, kahan, grcar, parter, pei,
    redheffer, triw, gear, gepp_growth,
    gaussian_device, uniform_device, bernoulli, rademacher, wigner, haar,
    normal_uniform_spectrum,
    demmel, druinsky_toledo, egorov, extended_kahan, fiedler, fox_li,
    gks, hanowa, helmholtz_1d, helmholtz_2d, helmholtz_3d, laplacian_3d,
    jordan_cholesky, lauchli, legendre, lotkin, one_two_one, riffle,
    ris, whale, hatano_nelson, three_valued, kms,
)
