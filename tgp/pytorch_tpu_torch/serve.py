"""Serving API: bucketed batched predictors (counterpart of `serve.py`).

Requests are padded to a small set of batch buckets, as in the JAX package,
so every request of a bucket runs the same shapes.  Each request is one
pass on the device: moments, samples and quantile bands are computed there
and come back to the host in one packed copy.  PyTorch is eager and does no
common-subexpression elimination, so the band path computes `marginal_qf`
once and shares it between the moments and the samples.

Typical use:

    predictor = Predictor(spec, params, Y_std=..., buckets=(256, 4096))
    out = predictor.predict(Xq)                  # moments + 95% bands
    out = predictor.predict(Xq, samples=200)     # + predictive samples
    lp  = predictor.log_prob(Xq, Yq)             # total log-density

A classification model answers {"probs": (n, C)}, one `marginal_qf` a
request.  A warped-GP model's moments, samples and bands come back in data
units through the warp's inverse (Newton's method for a warp without an
analytic one).  A deep TGP (`models.deep.DeepTGPSpec`) propagates each
request's rows once, along max(spec.S_test, samples) paths from the
request's generator: one `marginal_qf` a layer, shared by the moments (the
mixture over spec.S_test paths), the samples and the bands (one sample a
path); `log_prob` is the double-integration estimator over spec.S_test
paths.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from . import config as cfg
from .models import deep, tgp as tgp_mod
from .models.tgp import TGPSpec
from .weights import tree_map


def _bucket_for(n: int, buckets):
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds the largest bucket {buckets[-1]}; "
                     f"shard the request or add a bucket")


class Predictor:
    """Predictive service for a trained TGP.

    Args:
      spec, params: the model (params are moved to `device` and cast to the
        configured precision, `config.default_dtype()`).
      Y_std, Y_mean: de-normalisation of the regressed variable (outputs are
        returned in the original data scale).
      buckets: allowed padded batch sizes.
      S_MC, fully_bayesian: with fully_bayesian, the moments marginalise
        the flow's hypernets over S_MC draws and every sample takes its own
        draw (MC-dropout or VI posterior of an input-dependent flow), from
        the request's generator; still one `marginal_qf` per request.
      seed: base of the per-request random streams.
      device: where requests run; None means the card (raises without one).
    """

    def __init__(self, spec: TGPSpec, params, Y_std=1.0, Y_mean=0.0,
                 buckets=(256, 4096), S_MC: int = 100,
                 fully_bayesian: bool = False, seed: int = 0, device=None):
        tgp_mod.check_spec(spec)
        self.device = cfg.resolve_device(device)
        self.dtype = cfg.default_dtype()
        self.np_dtype = np.float64 if self.dtype == torch.float64 else np.float32
        self.spec = spec
        self.params = tree_map(lambda t: t.to(self.device, self.dtype), params)
        self.Y_std = np.asarray(Y_std, dtype=np.float64).reshape(-1)
        self.Y_mean = np.asarray(Y_mean, dtype=np.float64).reshape(-1)
        self._Y_std_dev = torch.as_tensor(self.Y_std, dtype=self.dtype).to(
            self.device)
        self.buckets = tuple(sorted(buckets))
        self.S_MC = S_MC
        self.fully_bayesian = fully_bayesian
        self.seed = int(seed)
        self._calls = itertools.count()

    def _next_generator(self) -> torch.Generator:
        """A fresh generator for one request.

        Its seed mixes (seed, request counter) through numpy's SeedSequence,
        so streams are distinct per request and reproducible from `seed`.
        The counter comes from itertools.count, whose next() is atomic under
        the GIL, so concurrent callers get distinct streams.
        """
        ctr = next(self._calls)
        s = np.random.SeedSequence((self.seed, ctr)).generate_state(1, np.uint64)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(s[0]))
        return gen

    def _to_device(self, a):
        # pageable host memory: non_blocking skips the stream sync a blocking
        # copy would make, so `map` keeps earlier requests in flight
        return torch.from_numpy(a).to(self.device, non_blocking=True)

    def _pad(self, X):
        X = np.asarray(X, self.np_dtype)
        n = X.shape[0]
        if n == 0:
            raise ValueError("empty request (0 rows)")
        b = _bucket_for(n, self.buckets)
        if n < b:
            X = np.concatenate([X, np.repeat(X[-1:], b - n, axis=0)], axis=0)
        return np.ascontiguousarray(X), n

    @torch.no_grad()
    def _dispatch(self, X, samples, quantiles):
        """Enqueue one request's work on the device; returns a handle."""
        if quantiles:
            qs = tuple(sorted(float(q) for q in quantiles))
            if len(qs) != 2 or not 0.0 < qs[0] < qs[1] < 1.0:
                raise ValueError(
                    f"quantiles must be two values in (0, 1), got {quantiles}")
            quantiles = qs
        Xp, n = self._pad(X)
        Xd = self._to_device(Xp)
        spec, params = self.spec, self.params
        gen = (self._next_generator()
               if samples or quantiles or self._needs_rng else None)
        n_samples = (samples or 200) if samples or quantiles else 0
        if deep.is_deep(spec):
            # one propagation for the moments (spec.S_test paths) and the
            # samples (one a path)
            X_in = Xd
            qf = deep.propagate(spec, params, Xd, gen,
                                max(spec.S_test, n_samples))
        else:
            X_in = tgp_mod._ensure_3d(spec, Xd)
            qf = tgp_mod.marginal_qf(spec, params, X_in)
        m1, m2, _, _ = tgp_mod.predictive_distribution(
            spec, params, X_in, S_MC=self.S_MC,
            fully_bayesian=self.fully_bayesian, rng=gen, qf=qf)
        if m2 is None:              # classification: probabilities (MB, C)
            return m1, None, n, 0, None
        parts, y = [m1, m2], None
        if samples or quantiles:
            y, _, _ = tgp_mod.sample_predictive(spec, params, X_in, n_samples,
                                                gen, self.fully_bayesian, qf=qf)
            if quantiles:
                q = self._to_device(np.asarray(quantiles, self.np_dtype))
                qv = torch.quantile(y, q, dim=1)          # (2, Dy, MB)
                parts += [qv[0], qv[1]]
            if not samples:
                y = None
        return torch.stack(parts), y, n, samples, quantiles

    @property
    def _needs_rng(self) -> bool:
        return (self.fully_bayesian or deep.is_deep(self.spec)
                or self.spec.likelihood.kind == "categorical")

    def _materialize(self, handle, host):
        """Scale one request's host copies (packed, samples) to data units."""
        _, _, n, samples, quantiles = handle
        packed, y = host
        if self.spec.likelihood.is_classification:
            return {"probs": packed[:n]}
        ystd, ymean = self.Y_std[:, None], self.Y_mean[:, None]
        packed = packed[..., :n]
        out = {"mean": packed[0] * ystd + ymean, "var": packed[1] * ystd ** 2}
        if quantiles:
            out["lower"] = packed[2] * ystd + ymean
            out["upper"] = packed[3] * ystd + ymean
        if samples:
            out["samples"] = (y[..., :n] * ystd[:, None, :]
                              + ymean[:, None, :])
        return out

    def predict(self, X, samples: int = 0, quantiles=(0.025, 0.975)):
        """Predictive moments (original data scale) + optional sample-based
        quantile bands.

        Returns dict(mean (Dy,n), var, lower, upper[, samples (Dy,S,n)]);
        for classification dict(probs (n, C)).
        """
        h = self._dispatch(X, samples, quantiles)
        host = tuple(None if a is None else a.cpu().numpy() for a in h[:2])
        return self._materialize(h, host)

    def map(self, Xs, samples: int = 0, quantiles=(0.025, 0.975)):
        """Pipelined batch of independent requests.

        Launches every request's work first, then starts non-blocking copies
        of all results into pinned host memory, then synchronises once.
        Returns a list of predict() dicts in request order."""
        handles = [self._dispatch(X, samples, quantiles) for X in Xs]
        # a non-blocking copy from the card lands in pinned host memory
        hosts = [[None if a is None else a.to("cpu", non_blocking=True)
                  for a in h[:2]] for h in handles]
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return [self._materialize(h, tuple(None if b is None else b.numpy()
                                           for b in bufs))
                for h, bufs in zip(handles, hosts)]

    @torch.no_grad()
    def log_prob(self, X, Y):
        """Per-request total predictive log-density, original data scale."""
        Xp, n = self._pad(X)
        Y = np.asarray(Y, self.np_dtype)
        if Y.shape[0] < Xp.shape[0]:
            Y = np.concatenate(
                [Y, np.repeat(Y[-1:], Xp.shape[0] - n, axis=0)], axis=0)
        lpp = tgp_mod.test_log_likelihood(
            self.spec, self.params, self._to_device(Xp),
            self._to_device(np.ascontiguousarray(Y)), self._Y_std_dev,
            S_MC=self.S_MC, fully_bayesian=self.fully_bayesian,
            rng=self._next_generator() if self._needs_rng else None,
            reduce=False)
        return lpp[..., :n].sum(dim=-1).cpu().numpy()
