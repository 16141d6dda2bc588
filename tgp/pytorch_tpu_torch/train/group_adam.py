"""Per-leaf grouped Adam family with torch `add_param_group` semantics: the
torch counterpart of the JAX package's `train/group_adam.py`, on tensors
updated in place.

The reference keeps one live optimizer across schedule phases and train()
calls: a parameter added in a later phase starts with fresh moments and its
own step count, while the others keep theirs.  So the state holds moments
for every leaf, and each step takes per-leaf (lr, weight_decay, active)
annotations:

  * an inactive leaf (frozen, lr=0 or not yet added) takes no step,
    accumulates no moments and keeps its count;
  * bias correction uses the leaf's own count, and b1**t and b2**t are
    computed in the leaf's dtype;
  * `kind` selects the rule; all three share the (count, mu, nu) state:
      - 'adam':   torch Adam, weight decay as L2 added to the gradient
                  before the moments;
      - 'adam_W': torch AdamW, decoupled decay -lr*wd*p, eps outside the
                  bias-corrected sqrt;
      - 'adam_R': RAdam with degenerated_to_sgd=False, as the reference
                  builds it: the rectified step when rho_t >= 5 and NO
                  update at all below (not even the weight decay), while the
                  moments and the count still accumulate.  torch.optim.RAdam
                  takes an SGD step there instead, so it is not used.

Counts are Python ints on the host, so the bias corrections and RAdam's
rectification are host scalars: a step makes no host sync.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..weights import tree_leaves, tree_unflatten
from .optimizers import _parse_specs, param_paths

KINDS = ("adam", "adam_W", "adam_R")


@dataclasses.dataclass
class GroupAdamState:
    """Per-leaf step counts and moments, in `weights.tree_leaves` order."""

    count: List[int]
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def init_state(params) -> GroupAdamState:
    leaves = tree_leaves(params)
    return GroupAdamState(count=[0] * len(leaves),
                          mu=[torch.zeros_like(p) for p in leaves],
                          nu=[torch.zeros_like(p) for p in leaves])


def _np_dtype(t):
    return np.float64 if t.dtype == torch.float64 else np.float32


@torch.no_grad()
def update(grads, state: GroupAdamState, params, lr_tree, wd_tree, active_tree,
           b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
           kind: str = "adam"):
    """One step of the `kind` rule, applied in place to `params` and `state`.

    grads, params and the annotation trees share one structure (or are the
    flat lists of their leaves); lr and wd are per-leaf floats, active
    per-leaf bools.
    """
    if kind not in KINDS:
        raise NotImplementedError(f"grouped optimizer kind {kind!r}")
    for i, (g, p, lr, wd, active) in enumerate(zip(
            tree_leaves(grads), tree_leaves(params), tree_leaves(lr_tree),
            tree_leaves(wd_tree), tree_leaves(active_tree))):
        if not active:
            continue
        mu, nu = state.mu[i], state.nu[i]
        if kind == "adam" and wd:
            g = g + wd * p                            # torch L2-into-grad
        state.count[i] += 1
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * torch.square(g))
        dt = _np_dtype(p)
        t = dt(state.count[i])
        b1t, b2t = dt(b1) ** t, dt(b2) ** t
        one = dt(1)
        if kind in ("adam", "adam_W"):
            mu_hat = mu / float(one - b1t)
            nu_hat = nu / float(one - b2t)
            upd = -lr * mu_hat / (torch.sqrt(nu_hat) + eps)
            if kind == "adam_W":
                upd = upd - lr * wd * p
        else:
            rho_inf = dt(2.0 / (1.0 - b2) - 1.0)
            rho_t = rho_inf - dt(2) * t * b2t / (one - b2t)
            if not rho_t >= 5.0:
                continue                              # no step, not even wd
            r = np.sqrt(max((one - b2t) * (rho_t - dt(4)) / (rho_inf - dt(4))
                            * (rho_t - dt(2)) / rho_t * rho_inf
                            / (rho_inf - dt(2)), dt(0)))
            upd = (float(dt(-lr) * (r / (one - b1t))) * mu
                   / (torch.sqrt(nu) + eps) - wd * lr * p)
        p.add_(upd)


def annotations_from_specs(params, specs, global_lr, frozen_labels=None,
                           default_wd: float = 0.0):
    """(lr_tree, wd_tree, active_tree) from reference-style specs
    ([lr(, wd), name] substring entries; lr=0 or frozen -> inactive).

    default_wd applies to unmatched parameters and to 2-entry specs, as a
    torch param group without weight_decay takes the optimizer's default
    (0.01 for torch AdamW, which the reference runs with its defaults).
    """
    parsed = _parse_specs(specs, default_wd)
    paths = param_paths(params)
    flat_paths = tree_leaves(paths)
    flat_frozen = (tree_leaves(frozen_labels) if frozen_labels is not None
                   else [False] * len(flat_paths))

    def annotate(path, frozen):
        if frozen:
            return 0.0, 0.0, False
        for lr, wd, name in parsed:
            if name in path:
                return lr, wd, lr != 0.0
        return float(global_lr), float(default_wd), True

    ann = [annotate(p, f) for p, f in zip(flat_paths, flat_frozen)]
    return tuple(tree_unflatten(paths, [a[k] for a in ann]) for k in range(3))
