"""tgp.pytorch_tpu_torch — the PyTorch/CUDA port of `tgp.pytorch_tpu`.

The JAX package `tgp.pytorch_tpu` is the reference; this package keeps its
module and function names so each counterpart is easy to find, and uses
PyTorch idiom inside: plain functions on tensors, dict parameter trees, an
explicit `device` and explicit `torch.Generator`s.  It imports neither JAX
nor anything of the JAX package.

Ported: the JAX package's library surface (the lazy top-level names
below, each subpackage's exports, `models.TGP` and `models.svgp_spec`, and
its two examples as `examples.quickstart` and `examples.deep_tgp`), serving
and training (`serve.Predictor`, `train.Trainer`, with Adam, SGD, natural
gradients and L-BFGS, `train.lbfgs`), checkpoints and bit-exact resume
(`train.checkpoint`), the experiment CLI for SVGP, TGP, ID_TGP, WGP and
DGP (`experiments.main`), the classification protocol
(`experiments.classification_protocol`), the multi-seed battery
(`train.multiseed`, `experiments.battery`, `spec.remat` included) and the
sweep runner (`experiments.sweep`), metric logging and profiling
(`utils`), the large corpora and their loaders (`data.large`,
`data.native`), the Trainer's host loop and `spec.remat`, 'bf16' precision
and the 'rbg' stream (`config`), and dp x ty meshes of ranks (`parallel`)
through the Trainer, the battery and the CLIs, over every point-estimate
and input-dependent flow, every kernel kind and likelihood, with the fused
ARD-RBF Gram and its VJP as hand-written CUDA kernels (`ops/rbf_gram.py`,
`csrc/`).

    from tgp.pytorch_tpu_torch import (TGPSpec, init_tgp_params, Trainer,
                                       Predictor, LikelihoodSpec,
                                       return_dataset, kmeans_centers)

Entry points run on the card unless the caller passes `device="cpu"`.
"""

from . import config
from .config import set_precision, default_dtype, default_device

__version__ = "0.1.0"


def __getattr__(name):
    """The lazy top-level API, as the JAX package's (importing the package
    loads only `config`): TGPSpec, TGP, svgp_spec, init_tgp_params,
    Trainer, Predictor, return_dataset, kmeans_centers, LikelihoodSpec."""
    if name in ("TGPSpec", "TGP", "svgp_spec", "init_tgp_params"):
        from .models import tgp as _tgp
        return getattr(_tgp, name)
    if name == "Trainer":
        from .train.trainer import Trainer
        return Trainer
    if name == "Predictor":
        from .serve import Predictor
        return Predictor
    if name in ("return_dataset", "kmeans_centers"):
        from . import data as _data
        return getattr(_data, name)
    if name == "LikelihoodSpec":
        from .likelihoods.gaussian import LikelihoodSpec
        return LikelihoodSpec
    raise AttributeError(name)
