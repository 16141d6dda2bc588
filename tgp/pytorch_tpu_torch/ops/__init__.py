from .transforms import positive, inverse_positive, softplus, inv_softplus
from .quadrature import gauss_hermite, GaussHermite
from .linalg import (
    safe_cholesky,
    tril_solve,
    triu_solve,
    cholesky_solve,
    batched_log_gaussian,
    kl_whitened,
    kl_gaussian,
)
