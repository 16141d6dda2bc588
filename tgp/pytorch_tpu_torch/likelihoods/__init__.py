from .gaussian import (
    LikelihoodSpec,
    init_likelihood_params,
    gaussian_ell,
    gaussian_flow_ell,
    gaussian_moments,
    gaussian_flow_moments,
    gaussian_log_marginal,
    noise_variance,
)
from .classification import bernoulli_ell, bernoulli_moments, categorical_ell, categorical_moments
from .warped import warped_ell, warped_moments, warped_unwarped_moments, warped_log_marginal
