"""Deep TGP example: a 2-layer stack on step-function data.

Deep GPs shine on non-stationary targets: the inner layer learns an input
warp so the outer (stationary-kernel) layer sees smooth data.  Compare the
test log-density against a shallow SVGP.

    python -m tgp.pytorch_tpu_torch.examples.deep_tgp [--platform cpu] [--epochs 1500]

The JAX package's `examples/deep_tgp.py` through the port's public names,
with the same data, models, training and printed lines.  It runs on the
card unless `--platform cpu`.
"""

import argparse

import numpy as np

from ..experiments.battery import device_of


def data():
    """(X, Y, Xte, Yte): 160 noisy steps on [-2, 2] and a clean test grid."""
    rng = np.random.RandomState(0)
    N = 160
    X = np.sort(rng.uniform(-2, 2, (N, 1)), axis=0)
    Y = np.where(X > 0, 1.0, -1.0) + 0.05 * rng.randn(N, 1)
    Xte = np.linspace(-2, 2, 200)[:, None]
    Yte = np.where(Xte > 0, 1.0, -1.0)
    return X, Y, Xte, Yte


def _loaders(X, Y, Xte, Yte):
    from ..data.batching import ArrayDataset, DataLoader
    return [DataLoader(ArrayDataset(X, Y), 200, seed=0),
            DataLoader(ArrayDataset(Xte, Yte), 200, shuffle=False)]


def shallow(epochs: int, device) -> dict:
    """The shallow SVGP baseline trained on `device` (no draws): its
    initial params, trainer and test metrics."""
    from ..ops import kernels as K
    from ..models import TGPSpec, init_tgp_params
    from ..likelihoods import LikelihoodSpec
    from ..train import Trainer

    X, Y, Xte, Yte = data()
    spec = TGPSpec(Dy=1, Dx=1, M=16, N=float(X.shape[0]),
                   kernel=K.from_name("scale_rbf"),
                   likelihood=LikelihoodSpec("gaussian", 1))
    p = init_tgp_params(spec, X, X[::10][:16], variance_scale=1e-5,
                        device=device)
    tr = Trainer(spec, p, _loaders(X, Y, Xte, Yte), Y_std=np.ones(1),
                 S_test=50, device=device)
    tr.train(epochs, 0.02, "adam", verbose_each=0)
    return dict(params=p, trainer=tr, metrics=tr.compute_metrics()["test"])


def deep(epochs: int, device) -> dict:
    """The 2-layer deep TGP (inner layer with the Salimbeni identity mean)
    trained on `device`: its initial params, trainer and test metrics."""
    from ..ops import kernels as K
    from ..models import (TGPSpec, DeepTGPSpec, layer_spec,
                          init_deep_params)
    from ..likelihoods import LikelihoodSpec
    from ..train import Trainer

    X, Y, Xte, Yte = data()
    N = float(X.shape[0])
    kernel = K.from_name("scale_rbf")
    spec = DeepTGPSpec(layers=(
        layer_spec(1, 1, 16, N, kernel),
        TGPSpec(Dy=1, Dx=1, M=16, N=N, kernel=kernel,
                likelihood=LikelihoodSpec("gaussian", 1)),
    ), S_train=1, S_test=50)
    p = init_deep_params(spec, X, X[::10][:16], variance_scale=1e-5,
                         device=device)
    tr = Trainer(spec, p, _loaders(X, Y, Xte, Yte), Y_std=np.ones(1),
                 S_test=50, seed=1, device=device)
    tr.train(epochs, 0.02, "adam", verbose_each=0)
    return dict(params=p, trainer=tr, metrics=tr.compute_metrics()["test"])


def run(epochs: int, device) -> dict:
    """Both models on `device` in fp64, the JAX example's lines printed:
    {"shallow": shallow(...), "deep": deep(...)}."""
    from .. import config as cfg
    # small problem; fp64 keeps the S_train=1 gradient noise benign
    cfg.set_precision("fp64")
    sh, dp = shallow(epochs, device), deep(epochs, device)
    m_sh, m_dp = sh["metrics"], dp["metrics"]
    print(f"shallow SVGP : test logL {float(m_sh['logL'][0]):+.3f}  "
          f"rmse {float(m_sh['rmse'][0]):.4f}")
    print(f"2-layer deep : test logL {float(m_dp['logL'][0]):+.3f}  "
          f"rmse {float(m_dp['rmse'][0]):.4f}")
    print("(deep wins log-density by calibrating uncertainty at the step)")
    return {"shallow": sh, "deep": dp}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default="gpu", choices=["gpu", "cpu"])
    ap.add_argument("--epochs", type=int, default=1500)
    args = ap.parse_args(argv)
    return run(args.epochs, device_of(args))


if __name__ == "__main__":
    main()
