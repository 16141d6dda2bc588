"""The port's `--model WGP` (the warped GP) against the JAX CLI's
(`experiments/main.py`), on the CPU in fp64.

Both `run`s take the same flags: boston split 1, M=5, 20 epochs, for each
`--warp_arch` (SAL(1); log_exp with 3 softplus terms, whose inverse is
Newton's; StepTanhL(1, 3) with y added, identity-fitted for 2000 epochs
first).  No draw is taken in training or in the warped likelihood's
evaluation, so nothing is replayed.  The JAX run's k-means centers,
identity fit and Trainer are caught as in `test_torch_port_cli.py`.
Compared at rtol 1e-8, atol 1e-10: Z0, the warp's spec, the identity fit,
the ELBO, ELL and KL curves, every final parameter (the warp's included),
logL and RMSE, and the printed result line but its time.

SAL's trajectory after the first step is held at `SAL_KICK` instead.  At
the initial parameters its warp is the identity and the standardised
targets have mean 0, so the gradient of the affine step's shift is
rounding noise: 2.3e-13 in the JAX package's eager ELBO, 3.6e-15 in its
jitted one, 1.6e-13 in the port's, against 1e4 for the other warp leaves
(`test_torch_port_likelihoods.py` holds every other gradient there at rtol
1e-8).  Adam's first step turns that noise into a step of up to 1e-5 of
lr, and the rest of the run answers the kick: the port on 1 and 8 threads
repeats itself to the last bit, and sits from the JAX CLI 6.4e-9 on the
ELBO curve, 8.3e-10 on the KL curve, 6.9e-7 of a leaf's largest entry and
2.9e-8 on the metrics.  `SAL_KICK` is 10x those gaps.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import tgp.pytorch_tpu.flows.initializers as jinit
from tgp.pytorch_tpu_torch.experiments import main as pmain
from tgp.pytorch_tpu_torch import weights

from test_torch_port_cli import (ARGV, F64, _port_state, close,  # noqa: F401
                                 jax_run, result_line)

# the curves and metrics relative to each entry, a leaf relative to its
# largest entry
SAL_KICK = dict(curve=6.4e-8, kld=8.3e-9, leaf=6.9e-6, metric=2.9e-7)


@pytest.mark.parametrize("arch", ["SAL", "log_exp", "StepTanhL"])
def test_wgp_cli_matches_the_jax_cli(monkeypatch, capsys, arch):
    argv = ["--model", "WGP", "--warp_arch", arch] + ARGV
    fits = []
    fit = jinit.fit_flow_to_identity

    def host_fit(*a, **k):
        # host copies: the JAX Trainer donates the fitted warp it is given
        out = fit(*a, **k)
        fits.append(jax.tree_util.tree_map(np.array, out[1]))
        return out

    monkeypatch.setattr(jinit, "fit_flow_to_identity", host_fit)
    mj, seen = jax_run(monkeypatch, argv)
    jline = result_line(capsys.readouterr().out)
    torch.set_num_threads(1)
    res = pmain.run(pmain.parse_args(argv))
    pline = result_line(capsys.readouterr().out)
    assert pline == jline and pline.startswith("Dataset boston, M 5, WGP,")

    close(res.Z0, seen["Z0"])
    jt, pt = seen["trainer"], res.trainer
    assert pt.spec.likelihood.kind == "warped" and not pt.spec.has_flow
    assert [dataclasses.astuple(s) for s in pt.spec.likelihood.warp_flow] == \
        [dataclasses.astuple(s) for s in jt.spec.likelihood.warp_flow]
    kinds = [s.kind for s in pt.spec.likelihood.warp_flow]
    assert kinds == {"SAL": ["sinh_arcsinh", "affine"], "log_exp": ["log_exp"],
                     "StepTanhL": ["step_flow", "affine"]}[arch]
    if arch == "StepTanhL":
        jmse, jparams = seen["fit"][2], fits[0]
        pspec, pparams, pmse = res.identity_fit
        close(pmse, jmse)
        jl, pl = jax.tree_util.tree_leaves(jparams), weights.tree_leaves(pparams)
        assert len(jl) == len(pl) == 14      # 3 x (a, b, c, d), affine a, b
        for a, b in zip(jl, pl):
            close(b, a)
    else:
        assert res.identity_fit is None and "fit" not in seen
    lim = SAL_KICK if arch == "SAL" else None
    for attr in ("loss_curve", "ell_curve", "kld_curve"):
        got = np.asarray(getattr(pt, attr), np.float64)
        want = np.asarray([float(v) for v in getattr(jt, attr)])
        assert got.shape == want.shape == (20,)
        close(got[0], want[0])
        close(got, want, **(dict(rtol=lim["kld" if attr == "kld_curve"
                                          else "curve"], atol=0)
                            if lim else F64))
    jl = jax.tree_util.tree_leaves_with_path(jt.params)
    pl = weights.tree_leaves(pt.params)
    assert len(jl) == len(pl)
    assert any("warp" in jax.tree_util.keystr(p) for p, _ in jl)
    for (path, a), b in zip(jl, pl):
        tol = (dict(rtol=0, atol=lim["leaf"] * np.abs(a).max()) if lim
               else F64)
        close(b, a, err_msg=jax.tree_util.keystr(path), **tol)
    for split in ("train", "test"):
        for k in ("logL", "rmse"):
            close(res.metrics[split][k], mj[split][k],
                  **(dict(rtol=lim["metric"], atol=0) if lim else F64))
    assert res.kernel_calls == {"train": (0, 0), "eval": (0, 0)}
