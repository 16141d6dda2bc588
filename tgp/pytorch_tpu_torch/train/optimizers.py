"""Parameter paths and the grouped stateless SGD step: the torch counterpart
of the JAX package's `train/optimizers.py`.

A schedule specification is a list of [lr, name] or [lr, weight_decay, name]
entries; `name` substring-matches the '/'-joined path of a parameter, the
first match wins, lr == 0.0 removes the parameter from optimisation, and an
unmatched parameter gets the global lr.

The Adam family ('adam', 'adam_W', 'adam_R') is `train/group_adam.py`, which
carries its moments across schedule phases.  'sgd' is torch SGD at momentum
0: stateless, with L2 weight decay added to the gradient, so each phase
builds it afresh.  L-BFGS (`lbfgs_optimizer`, `train/lbfgs.py`) is a
full solver with its own line search: the Trainer runs it full batch, and
it does not compose with parameter groups or schedules.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..weights import tree_leaves, tree_unflatten
from .lbfgs import LBFGS


def _parse_specs(specs, default_wd: float = 0.0):
    """[(lr, wd, name)] from [lr(, wd), name] entries."""
    parsed = []
    for s in specs or []:
        if len(s) == 3:
            lr, wd, name = s
        elif len(s) == 2:
            (lr, name), wd = s, default_wd
        else:
            raise ValueError("spec entries must be [lr, name] or [lr, wd, name]")
        parsed.append((float(lr), float(wd), str(name)))
    return parsed


#: the JAX package's refusal of L-BFGS as a grouped or per-phase optimizer
#: (JAX `train/optimizers.py:37-42`)
LBFGS_REFUSAL = (
    "lbfgs is a full solver with its own linesearch — it does not "
    "compose with parameter groups / schedules; use "
    "Trainer.train(opt='lbfgs') without an optimisation_schedule, "
    "or lbfgs_optimizer() directly")


def lbfgs_optimizer(memory_size: int = 15) -> LBFGS:
    """L-BFGS with the zoom line search (strong-Wolfe stepsizes), as the
    JAX package builds it: memory 15, at most 25 line-search trials, the
    stepsize from the line search (`train/lbfgs.py`).  Its `update` takes
    the value, the gradient and a value-and-gradient function (see the
    Trainer's L-BFGS phase)."""
    return LBFGS(memory_size=memory_size)


def make_optimizer(opt: str, lr: float, weight_decay: float = 0.0):
    """Single-group 'sgd' step: a function (g, p) -> the update to add to p,
    -lr * (g + weight_decay * p)."""
    if opt == "lbfgs":
        raise NotImplementedError(LBFGS_REFUSAL)
    if opt in ("adam", "adam_W", "adam_R"):
        raise NotImplementedError(
            f"{opt!r} is train/group_adam.py in the port, for the Trainer "
            "and train/multiseed.py alike")
    if opt != "sgd":
        raise NotImplementedError(f"optimizer {opt!r}")

    def step(g, p):
        if weight_decay > 0.0:
            g = g + weight_decay * p
        return -lr * g

    return step


def param_paths(params):
    """The '/'-joined path of every leaf, in a tree shaped as params: dict
    keys by name, list entries by index ('kernel/child/raw_lengthscale',
    'flow/0/a'), the JAX package's strings for the same tree."""

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(tree[k], f"{prefix}{k}/") for k in sorted(tree)}
        if isinstance(tree, (list, tuple)):
            return [walk(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
        return prefix[:-1]

    return walk(params, "")


def build_grouped_optimizer(params, specs: Sequence, global_lr: float,
                            opt: str = "sgd", frozen_labels=None):
    """The grouped 'sgd' step from reference-style specs.

    frozen_labels, when given, is a tree of bools marking always-frozen
    leaves.  Returns (update, labels): `update(grads, params)` maps trees of
    gradients and parameters to the tree of updates (zero for frozen
    leaves), and labels names each leaf's group ('__global__', 'group<i>'
    or '__frozen__').
    """
    parsed = _parse_specs(specs)
    paths = param_paths(params)
    flat_paths = tree_leaves(paths)
    flat_frozen = (tree_leaves(frozen_labels) if frozen_labels is not None
                   else [False] * len(flat_paths))

    def label_of(path, is_frozen):
        if is_frozen:
            return "__frozen__"
        for i, (lr, _, name) in enumerate(parsed):
            if name in path:
                return "__frozen__" if lr == 0.0 else f"group{i}"
        return "__global__"

    flat_labels = [label_of(p, f) for p, f in zip(flat_paths, flat_frozen)]
    steps = {"__global__": make_optimizer(opt, global_lr)}
    for i, (lr, wd, _) in enumerate(parsed):
        if lr != 0.0:
            steps[f"group{i}"] = make_optimizer(opt, lr, wd)

    def update(grads, params):
        return tree_unflatten(paths, [
            torch.zeros_like(g) if lab == "__frozen__" else steps[lab](g, p)
            for lab, g, p in zip(flat_labels, tree_leaves(grads),
                                 tree_leaves(params))])

    return update, tree_unflatten(paths, flat_labels)
