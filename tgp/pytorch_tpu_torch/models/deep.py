"""Deep TGP: stacked sparse variational GP layers with a flow-warped output
layer, trained with doubly-stochastic VI (Salimbeni & Deisenroth 2017); the
port of the JAX package's `models/deep.py`.

  * Each layer is a full `TGPSpec`, its marginal q(f) the shallow model's
    `marginal_qf`; inner layers default to the identity mean, so that
    f + m(x) keeps its rank through the stack.
  * Forward: S Monte Carlo paths go through the inner layers by
    reparameterised draws f ~ N(mu_l(F), var_l(F)).  The S axis folds into
    the row axis (row s*MB + mb is path s of input mb), so a layer is one
    `marginal_qf` call, one launch of the Gram kernel on the card, and no
    Python loop over the paths.
  * ELBO = N/MB * (1/S) sum_s ELL(y | last layer's marginal at F_s)
           - sum_l KL(q(U_l) || p(U_l)) - KL_flows(last layer),
    the last layer's ELL exact (closed form or quadrature through the flow).
  * Test log-likelihood: Gauss-Hermite quadrature per path, then a
    log-mean-exp over the S_test paths.

Every draw (one normal per inner layer, then the last layer's f0 and the
observation noise when sampling) goes through `flows.hypernet._draw`, from
the caller's `torch.Generator`.  `propagate` runs the inner layers once; a
caller that needs the log-likelihood, the moments and samples of the same
inputs passes its result as `prop` to each, so that they share one launch a
layer (the Trainer's evaluation, `serve.Predictor`).  Functions that take
`prop` use its first S paths (S = spec.S_test, or the samples asked for).
`models/tgp.py`'s public functions dispatch here on `spec.layers`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ..flows import hypernet
from ..ops.quadrature import GaussHermite
from ..likelihoods.gaussian import (
    LikelihoodSpec,
    gaussian_ell,
    gaussian_flow_ell,
    gaussian_flow_moments,
    gaussian_moments,
    noise_variance,
)
from . import tgp as tgp_mod
from .means import projection_matrix
from .tgp import TGPSpec
from .utils import propagate_inducing


@dataclasses.dataclass(frozen=True)
class DeepTGPSpec:
    """Static deep-TGP description: a tuple of layer TGPSpecs.

    layers[l].Dy is layer l's output width and must equal layers[l+1].Dx.
    The last layer's likelihood and flow are the observation model; the
    inner layers' likelihoods are unused.
    """

    layers: Tuple[TGPSpec, ...]
    S_train: int = 1
    S_test: int = 100

    def __post_init__(self):
        for a, b in zip(self.layers, self.layers[1:]):
            if a.Dy != b.Dx:
                raise ValueError(
                    f"layer width mismatch: Dy={a.Dy} feeds Dx={b.Dx}")
        if self.layers[-1].likelihood.kind not in ("gaussian", "gaussian_flow"):
            raise NotImplementedError(
                "DeepTGP supports gaussian / gaussian_flow output layers")

    # the Trainer's and the Predictor's view (TGPSpec's names)
    @property
    def Dy(self):
        return self.layers[-1].Dy

    @property
    def has_flow(self):
        return self.layers[-1].has_flow

    @property
    def has_stochastic_flow(self):
        return any(l.has_stochastic_flow for l in self.layers)

    @property
    def has_bn_flow(self):
        return any(l.has_bn_flow for l in self.layers)

    @property
    def likelihood(self):
        return self.layers[-1].likelihood


def is_deep(spec) -> bool:
    return hasattr(spec, "layers")


def layer_spec(Dx: int, Dy: int, M: int, N: float, kernel, *,
               mean: str = "identity", **kw) -> TGPSpec:
    """An inner layer's spec: the identity mean by default."""
    kw.setdefault("likelihood", LikelihoodSpec("gaussian", Dy))
    return TGPSpec(Dy=Dy, Dx=Dx, M=M, N=N, kernel=kernel, mean=mean, **kw)


def init_deep_params(spec: DeepTGPSpec, X, init_Z, *, rng=None,
                     propagate: str = "salimbeni", flow_inits=None,
                     dtype=None, device=None, **layer_kw):
    """{"layers": [each layer's params]}: each layer is `init_tgp_params` at
    its inputs; the inducing locations go through the stack by
    `propagate_inducing` (drawing from `rng` for the 'sampling' modes), and
    the inputs by the identity mean's projection of the training inputs.
    `flow_inits` initialises the last layer's flow."""
    X_l = np.asarray(X, np.float64)
    Z_l = np.asarray(init_Z, np.float64)
    layers = []
    for i, lsp in enumerate(spec.layers):
        is_last = i == len(spec.layers) - 1
        p = tgp_mod.init_tgp_params(
            lsp, X_l, Z_l, flow_inits=flow_inits if is_last else None,
            dtype=dtype, device=device, **layer_kw)
        layers.append(p)
        if not is_last:
            W = projection_matrix(lsp.Dx, lsp.Dy, X_l)
            Z_l = propagate_inducing(lsp, p, Z_l, lsp.Dy, rng=rng,
                                     how=propagate, W=W)
            X_l = X_l @ W
    return {"layers": layers}


def check_spec(spec: DeepTGPSpec) -> None:
    for lsp in spec.layers:
        tgp_mod.check_spec(lsp)


# ---------------------------------------------------------------------------
# the forward pass
# ---------------------------------------------------------------------------

def propagate(spec: DeepTGPSpec, params, X, rng, S: int,
              deterministic: bool = False):
    """X (MB, D0) through the inner layers with S reparameterised paths.

    Returns (F, mu, var, priors): F (S*MB, D_{L-1}) the last layer's inputs,
    (mu, var) its marginal (Dy_L, S*MB), and each layer's prior block for
    the unwhitened KL (`tgp._marginal_qf`; None when whitened).
    `deterministic` follows the mean path (eps = 0) and draws nothing."""
    MB = X.shape[0]
    F = X.unsqueeze(0).expand((S,) + tuple(X.shape)).reshape(S * MB,
                                                            X.shape[-1])
    priors = []
    for i, lsp in enumerate(spec.layers[:-1]):
        mu, var, prior = tgp_mod._marginal_qf(lsp, params["layers"][i], F,
                                              diagonal=True)   # (Dy_l, S*MB)
        priors.append(prior)
        if deterministic:
            F = mu.transpose(0, 1)
            continue
        if rng is None:
            raise ValueError("the deep model's inner layers draw from an rng")
        eps = hypernet._draw("normal", tuple(mu.shape), None, rng, mu.dtype,
                             mu.device)
        F = (mu + torch.sqrt(var) * eps).transpose(0, 1)     # (S*MB, Dy_l)
    mu, var, prior = tgp_mod._marginal_qf(spec.layers[-1], params["layers"][-1],
                                          F, diagonal=True)  # (Dy_L, S*MB)
    priors.append(prior)
    return F, mu, var, priors


def _paths(prop, S: int, MB: int):
    """The first S paths of a propagation (its columns are path-major)."""
    F, mu, var, priors = prop
    if mu.shape[-1] < S * MB:
        raise ValueError(f"the propagation holds {mu.shape[-1] // MB} paths, "
                         f"{S} asked for")
    return F[:S * MB], mu[..., :S * MB], var[..., :S * MB], priors


def _last_warp(spec: DeepTGPSpec, params, F, rng, stochastic, train=False):
    last = spec.layers[-1]
    return tgp_mod._make_warp(last, params["layers"][-1],
                              tgp_mod._ensure_3d(last, F), rng,
                              stochastic=stochastic, train=train)


def elbo(spec: DeepTGPSpec, params, X, Y, rng=None):
    """Doubly-stochastic ELBO on one minibatch, from S_train paths: (elbo,
    ell, kld), 0-d tensors (maximise the elbo).  One `marginal_qf` a layer;
    the unwhitened layers' KL reuses its K_zz."""
    MB = X.shape[0]
    S = spec.S_train
    last = spec.layers[-1]
    F, mu, var, priors = propagate(spec, params, X, rng, S)
    Yt = Y.transpose(0, 1).repeat(1, S)                      # (Dy, S*MB)
    lik = last.likelihood
    lp = params["layers"][-1]["likelihood"]
    if lik.kind == "gaussian":
        ell = torch.sum(gaussian_ell(lik, lp, Yt, mu, var)) / S
    else:
        warp = _last_warp(spec, params, F, rng, stochastic=True, train=True)
        ell = torch.sum(gaussian_flow_ell(lik, lp, Yt, mu, var, warp)) / S
    kld = sum(torch.sum(tgp_mod.kld_qu(lsp, params["layers"][i], priors[i]))
              for i, lsp in enumerate(spec.layers))
    kld = kld + tgp_mod.flows_kld(last, params["layers"][-1])
    ell = last.N / MB * ell
    return ell - kld, ell, kld


def test_log_likelihood(spec: DeepTGPSpec, params, X, Y, Y_std, *,
                        S_MC: int = 1, fully_bayesian: bool = False,
                        rng=None, reduce: bool = True, prop=None):
    """log p(Y*|X*) per output by the double-integration estimator: GH
    quadrature per path, then log-mean-exp over the S_test paths; (Dy,), or
    (Dy, MB) with reduce=False.  Densities are rescaled by Y_std (Dy,).
    `S_MC` is unused (the JAX package's signature); with `fully_bayesian`
    the last layer's flow draws its hypernets from `rng`."""
    S, MB = spec.S_test, X.shape[0]
    last = spec.layers[-1]
    F, mu, var, _ = _paths(prop if prop is not None else
                           propagate(spec, params, X, rng, S), S, MB)
    gh = GaussHermite(last.likelihood.quad_points)
    locs = gh.shifted_locations(mu, var)                     # (Q, Dy, S*MB)
    if last.has_flow:
        locs = _last_warp(spec, params, F, rng, stochastic=fully_bayesian)(locs)
    c_y = noise_variance(last.likelihood, params["layers"][-1]["likelihood"])
    Dy = last.Dy
    Ys = Y_std.reshape(1, Dy, 1, 1)
    y = Y.transpose(0, 1).reshape(1, Dy, 1, MB)
    fk = locs.reshape(-1, Dy, S, MB)
    var_y = torch.square(Ys) * c_y.reshape(1, Dy, 1, 1)
    logp = -0.5 * (torch.log(2 * math.pi * var_y)
                   + torch.square(Ys * y - Ys * fk) / var_y)  # (Q, Dy, S, MB)
    logw = torch.log(gh.weights(mu.dtype, mu.device)).reshape(-1, 1, 1, 1)
    per_path = torch.logsumexp(logw + logp, dim=0) - 0.5 * math.log(math.pi)
    log_p = torch.logsumexp(per_path, dim=1) - math.log(S)  # (Dy, MB)
    return torch.sum(log_p, dim=-1) if reduce else log_p


def predictive_distribution(spec: DeepTGPSpec, params, X, *, S_MC: int = 1,
                            fully_bayesian: bool = False, rng=None, prop=None):
    """Moments of the mixture over the S_test paths: (m1, m2, mu, var),
    m1 and m2 (Dy, MB), mu and var the last layer's marginal (Dy, S*MB)."""
    S, MB = spec.S_test, X.shape[0]
    last = spec.layers[-1]
    F, mu, var, _ = _paths(prop if prop is not None else
                           propagate(spec, params, X, rng, S), S, MB)
    lik = last.likelihood
    lp = params["layers"][-1]["likelihood"]
    if lik.kind == "gaussian":
        m1s, m2s = gaussian_moments(lik, lp, mu, var)
    else:
        warp = _last_warp(spec, params, F, rng, stochastic=fully_bayesian)
        m1s, m2s = gaussian_flow_moments(lik, lp, mu, var, warp)
    Dy = last.Dy
    m1s = m1s.reshape(Dy, S, MB)
    m2s = m2s.reshape(Dy, S, MB)
    m1 = torch.mean(m1s, dim=1)
    m2 = torch.mean(m2s + torch.square(m1s), dim=1) - torch.square(m1)
    return m1, m2, mu, var


def _draw_last(spec, params, S, MB, rng, fully_bayesian, prop, X):
    """S paths' last-layer samples: (F, mu, var, f0, fk), f0 = mu + sqrt(var)
    eps and fk = the warp of f0, each (Dy, S*MB)."""
    F, mu, var, _ = _paths(prop if prop is not None else
                           propagate(spec, params, X, rng, S), S, MB)
    eps = hypernet._draw("normal", tuple(mu.shape), None, rng, mu.dtype,
                         mu.device)
    f0 = mu + torch.sqrt(var) * eps
    fk = f0
    if spec.layers[-1].has_flow:
        fk = _last_warp(spec, params, F, rng,
                        stochastic=fully_bayesian)(f0[None])[0]
    return F, mu, var, f0, fk


def sample_marginal(spec: DeepTGPSpec, params, X, S: int, rng,
                    fully_bayesian: bool = False, prop=None):
    """S doubly-stochastic samples of the warped last-layer marginal: one
    f0 ~ N(mu, var) a path, warped.  Returns (fk, mu, var, f0): fk and f0
    (S, Dy, MB); mu and var (Dy, S*MB) in the propagated layout."""
    MB = X.shape[0]
    Dy = spec.layers[-1].Dy
    _, mu, var, f0, fk = _draw_last(spec, params, S, MB, rng, fully_bayesian,
                                    prop, X)

    def to_s(a):
        return torch.movedim(a.reshape(Dy, S, MB), 1, 0)

    return to_s(fk), mu, var, to_s(f0)


def sample_predictive(spec: DeepTGPSpec, params, X, S: int, rng,
                      fully_bayesian: bool = False, prop=None):
    """S predictive samples (Dy, S, MB): propagate, draw the last layer,
    warp, add the observation noise.  Returns (y, f0, mu)."""
    MB = X.shape[0]
    last = spec.layers[-1]
    _, mu, _, f0, fk = _draw_last(spec, params, S, MB, rng, fully_bayesian,
                                  prop, X)
    c_y = noise_variance(last.likelihood, params["layers"][-1]["likelihood"])
    noise = hypernet._draw("normal", tuple(fk.shape), None, rng, fk.dtype,
                           fk.device)
    y = fk + torch.sqrt(c_y) * noise
    return y.reshape(last.Dy, S, MB), f0, mu


def finalize_batch_norm(spec: DeepTGPSpec, params, X):
    """Recalibrate the last layer's hypernet batch-norm statistics on its
    inputs along the mean path (one path, no draws); returns the params
    with the new statistics, or `params` itself without batch norm."""
    last = spec.layers[-1]
    if not last.has_bn_flow:
        return params
    ref = params["layers"][-1]["q_mu"]
    X = (X if torch.is_tensor(X) else torch.from_numpy(np.asarray(X))).to(
        ref.device, ref.dtype)
    F = propagate(spec, params, X, None, 1, deterministic=True)[0]
    layers = list(params["layers"])
    layers[-1] = tgp_mod.finalize_batch_norm(last, layers[-1], F)
    return dict(params, layers=layers)
