"""Quickstart: train a TGP on UCI boston and serve predictions.

    python -m tgp.pytorch_tpu_torch.examples.quickstart [--platform cpu] [--epochs 2000]

The JAX package's `examples/quickstart.py` through the port's public
names: the same data, model, initialisation, training, checkpoint and
served request, and the same printed lines.  It runs on the card unless
`--platform cpu`.
"""

import argparse

import numpy as np

from ..experiments.battery import device_of

#: where the checkpoint goes, relative to the working directory (the repo
#: ignores `checkpoints/`)
CHECKPOINT_DIR = "checkpoints/quickstart_torch"


def run(epochs: int, device, *, num_inducing: int = 50,
        precision: str = "fp32", checkpoint_dir: str = CHECKPOINT_DIR,
        verbose_each: int = 500) -> dict:
    """The quickstart on `device`: returns its spec, initial params,
    trainer, metrics, checkpoint path, predictor, served prediction and
    data."""
    from .. import config as cfg
    cfg.set_precision(precision)

    from .. import (TGPSpec, init_tgp_params, Trainer, Predictor,
                    LikelihoodSpec, return_dataset, kmeans_centers)
    from ..ops import kernels as K
    from ..flows import generators as G, spec_from_list
    from ..train.checkpoint import save_checkpoint
    from ..models.serialization import spec_to_json

    # 1. data: the reference's committed boston split (seed 1), z-scored
    loaders, dc = return_dataset("boston", 10000, None, seed=1)

    # 2. model: TGP with a 2-block SAL marginal flow
    np.random.seed(0)
    flow, flow_inits = spec_from_list(G.SAL(2))
    spec = TGPSpec(Dy=dc["Dy"], Dx=dc["Dx"], M=num_inducing,
                   N=float(dc["N_tr"]), kernel=K.from_name("scale_rbf"),
                   likelihood=LikelihoodSpec("gaussian_flow", dc["Dy"],
                                             quad_points=100),
                   flow=flow)
    params = init_tgp_params(
        spec, dc["X_tr"], kmeans_centers(dc["X_tr"], num_inducing, n_init=10),
        variance_scale=1e-5,
        kernel_init={"length_scale": 2.0, "kernel_scale": 2.0},
        noise_init=0.05, flow_inits=flow_inits, device=device)

    # 3. train: full batch, the ELBO curve read back once a chunk
    trainer = Trainer(spec, params, loaders, dc["Y_std"], S_test=100,
                      device=device)
    trainer.train(epochs, 0.01, "adam", verbose_each=verbose_each)
    metrics = trainer.compute_metrics()
    print("test:", {k: np.round(v, 3) for k, v in metrics["test"].items()})

    # 4. checkpoint (params + JSON spec)
    ckpt = save_checkpoint(checkpoint_dir, trainer.params, step=epochs,
                           extra={"spec": spec_to_json(spec)})
    print("checkpoint:", ckpt)

    # 5. serve: bucketed predictions in the original data scale
    predictor = Predictor(spec, trainer.params, Y_std=dc["Y_std"],
                          Y_mean=dc["Y_mean"], buckets=(128,), device=device)
    out = predictor.predict(dc["X_tr"][:10], samples=100)
    print("predictive mean:", np.round(out["mean"][0], 2))
    print("95% band low   :", np.round(out["lower"][0], 2))
    print("95% band high  :", np.round(out["upper"][0], 2))
    return dict(spec=spec, params=params, trainer=trainer, metrics=metrics, checkpoint=ckpt,
                predictor=predictor, prediction=out, data=dc)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--platform", default="gpu", choices=["gpu", "cpu"])
    p.add_argument("--epochs", type=int, default=2000)
    args = p.parse_args(argv)
    return run(args.epochs, device_of(args))


if __name__ == "__main__":
    main()
