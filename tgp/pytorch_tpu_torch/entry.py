"""Entry point of the port: the flagship TGP's ELBO, the counterpart of
`__graft_entry__.py::_flagship` and `entry`.

    python -m tgp.pytorch_tpu_torch.entry      # on the card; prints the ELBO
"""

from __future__ import annotations

import numpy as np
import torch

from . import config as cfg, weights
from .models import tgp as tgp_mod


def _flagship(device=None):
    """The flagship model (a 2-block SAL flow, a scale-RBF ARD kernel, 100
    Gauss-Hermite nodes) at N=512, M=64 on seeded random data: (spec,
    params, X, Y) with X (512, 4) and Y (512, 1) numpy arrays in the
    configured precision."""
    N, M = 512, 64
    rng = np.random.RandomState(0)
    X = rng.randn(N, 4)
    Y = rng.randn(N, 1)
    spec = weights.flagship_spec(N, M=M)
    params = weights.flagship_init(spec, X, variance_scale=1e-5, device=device)
    np_dt = np.float64 if cfg.default_dtype() == torch.float64 else np.float32
    return spec, params, X.astype(np_dt), Y.astype(np_dt)


def entry(device=None):
    """(fn, example_args): the ELBO of the flagship at N=512, M=64, with
    fn(params, X, Y) -> the ELBO as a 0-d tensor."""
    spec, params, X, Y = _flagship(device=device)

    def fn(params, X, Y):
        return tgp_mod.elbo(spec, params, X, Y)[0]

    dev = params["Z"].device
    return fn, (params, torch.from_numpy(X).to(dev), torch.from_numpy(Y).to(dev))


if __name__ == "__main__":
    fn, args = entry()
    print("entry ok, ELBO =", float(fn(*args)))
