from .gaussian import (
    LikelihoodSpec,
    init_likelihood_params,
    gaussian_ell,
    gaussian_flow_ell,
    gaussian_moments,
    gaussian_flow_moments,
    noise_variance,
)
