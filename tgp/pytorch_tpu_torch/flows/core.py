"""Marginal normalizing flows as pure functions: the point-estimate part of
the JAX package's `flows/core.py`.

A flow is a static spec (a tuple of `FlowStep` dataclasses) plus a list of
per-step parameter dicts aligned with it.  Every point-estimate kind is
ported: affine, translation, sinh_arcsinh, inverse_sinh_arcsinh, arcsinh,
inverse_arcsinh, sinh, tanh, boxcox, inverseboxcox (in log space), tukey_left,
tukey_right, normalCDF, log_exp, exp, log, softplus, softminus, identity and
step_flow (a positive combination of member steps with switch-off gates),
with their analytic inverses and the fixed-iteration Newton inverse.

Parameters may carry leading axes (the model stacks one flow per output):
a scalar parameter of shape (Dy, 1) broadcasts against f (..., Dy, MB), and
`log_exp`'s per-term vectors keep their terms on the last axis.

Input-dependent (hypernet) steps raise NotImplementedError until ROADMAP
Queue 1 item 13.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import config as cfg
from ..ops.transforms import (inv_softplus, safe_exp, safe_sinh, safe_tanh,
                              softplus)

_TODO_HYPER = ("input-dependent flows are not ported yet "
               "(ROADMAP Queue 1 item 13)")


@dataclasses.dataclass(frozen=True)
class FlowStep:
    kind: str
    set_restrictions: bool = False
    add_init_f0: bool = False
    input_dependent: bool = False
    hypernet: Optional[object] = None
    constraint: str = "none"          # boxcox: 'none' | 'sigmoid2' | 'sigmoid_ref'
    learnable: bool = True            # normalCDF
    n_terms: int = 1                  # log_exp number of terms
    sub: Tuple["FlowStep", ...] = ()  # step_flow members


@dataclasses.dataclass(frozen=True)
class FlowCtx:
    """Runtime context threaded through flow evaluation.

    The point-estimate path uses no randomness; `rng` (a torch.Generator)
    and `stochastic` are kept for the input-dependent flows to come.
    """

    rng: Optional[torch.Generator] = None
    stochastic: bool = True
    mean_only: bool = False
    train: bool = False


# parameter names per kind (point-estimate path)
_SCALAR_PARAMS = {
    "affine": ("a", "b"),
    "translation": ("b",),
    "sinh_arcsinh": ("a", "b"),
    "inverse_sinh_arcsinh": ("a", "b"),
    "arcsinh": ("a", "b", "c", "d"),
    "inverse_arcsinh": ("a", "b", "c", "d"),
    "sinh": ("a", "b", "c", "d"),
    "tanh": ("a", "b", "c", "d"),
    "boxcox": ("lam",),
    "inverseboxcox": ("lam",),
    "tukey_left": ("g", "h"),
    "tukey_right": ("g", "h"),
    "normalCDF": ("a", "b", "c", "d"),
    "log_exp": ("a", "b", "c"),
    "exp": (),
    "log": (),
    "softplus": (),
    "softminus": (),
    "identity": (),
}

#: kinds that the JAX package lets take hypernet (input-dependent) parameters
_HYPER_CAPABLE = ("sinh_arcsinh", "tanh")


# ===========================================================================
# Spec construction from the generators' list-of-(name, kwargs) format
# ===========================================================================

def spec_from_list(flow_list) -> Tuple[Tuple[FlowStep, ...], list]:
    """Convert the generators' `[('name', init_kwargs), ...]` lists into
    (spec, init_values), like the JAX package's `spec_from_list`."""
    steps, inits = [], []
    for name, kw in flow_list:
        kw = dict(kw) if kw else {}
        name = {"inverse_boxcox": "inverseboxcox"}.get(name, name)
        if name == "step_flow":
            sub_steps, sub_inits = spec_from_list(kw["flow_arr"])
            steps.append(FlowStep("step_flow",
                                  add_init_f0=bool(kw.get("add_init_f0", False)),
                                  sub=sub_steps))
            inits.append({"sub": sub_inits})
            continue
        if name not in _SCALAR_PARAMS:
            raise ValueError(f"unknown flow kind {name!r}")
        if name == "log_exp":
            a = np.asarray(kw["init_a"], dtype=np.float64).reshape(-1)
            steps.append(FlowStep("log_exp", n_terms=int(a.shape[0]),
                                  add_init_f0=bool(kw.get("add_init_f0",
                                                          False))))
            inits.append({"a": a,
                          "b": np.asarray(kw["init_b"], dtype=np.float64).reshape(-1),
                          "c": np.asarray(kw["init_c"], dtype=np.float64).reshape(-1)})
            continue
        if name in _HYPER_CAPABLE and kw.get("input_dependent", False):
            raise NotImplementedError(_TODO_HYPER)
        add_f0 = bool(kw.get("add_init_f0", False))
        set_res = bool(kw.get("set_restrictions", False)) or add_f0
        constraint = "none"
        if (name in ("boxcox", "inverseboxcox")
                and kw.get("constraint") not in (None, "none")):
            constraint = str(kw["constraint"])
        steps.append(FlowStep(name, set_restrictions=set_res, add_init_f0=add_f0,
                              constraint=constraint,
                              learnable=bool(kw.get("is_learnable", True))))
        init_vals = {}
        for pname in _SCALAR_PARAMS[name]:
            key = f"init_{pname}"
            if key in kw:
                init_vals[pname] = float(np.asarray(kw[key]).reshape(()))
        inits.append(init_vals)
    return tuple(steps), inits


def is_identity_spec(spec: Tuple[FlowStep, ...]) -> bool:
    return all(s.kind == "identity" for s in spec)


IDENTITY_SPEC: Tuple[FlowStep, ...] = (FlowStep("identity"),)


def check_step(step: FlowStep) -> None:
    """Raise for a step this port cannot evaluate: NotImplementedError for
    an input-dependent step, ValueError for an unknown kind."""
    if step.input_dependent or step.hypernet is not None:
        raise NotImplementedError(_TODO_HYPER)
    if step.kind == "step_flow":
        for s in step.sub:
            check_step(s)
    elif step.kind not in _SCALAR_PARAMS:
        raise ValueError(f"unknown flow kind {step.kind!r}")


# ===========================================================================
# Parameter initialisation
# ===========================================================================

_DEFAULT_INIT = {
    "affine": {"a": 1.0, "b": 0.0},
    "translation": {"b": 0.0},
    "sinh_arcsinh": {"a": 0.0, "b": 1.0},
    "inverse_sinh_arcsinh": {"a": 0.0, "b": 1.0},
    "arcsinh": {"a": 0.0, "b": 1.0, "c": 0.0, "d": 1.0},
    "inverse_arcsinh": {"a": 0.0, "b": 1.0, "c": 0.0, "d": 1.0},
    "sinh": {"a": 0.0, "b": 1.0, "c": 0.0, "d": 1.0},
    "tanh": {"a": 0.0, "b": 1.0, "c": 0.0, "d": 1.0},
    "boxcox": {"lam": 5.0},
    "inverseboxcox": {"lam": 5.0},
    "tukey_left": {"g": 0.1, "h": 0.1},
    "tukey_right": {"g": 0.1, "h": 0.1},
    "normalCDF": {"a": 0.0, "b": 1.0, "c": 0.0, "d": 1.0},
}

#: step_flow members that get a switch-off gate
_GATED = ("boxcox", "inverseboxcox", "sinh_arcsinh")


def init_flow_params(spec: Tuple[FlowStep, ...], inits=None, dtype=None,
                     device=None):
    """Parameter list (one dict per step) for `spec`, with the JAX
    package's defaults: 0-d tensors, `log_exp`'s (n_terms,) vectors, and
    for a step_flow {"sub": [member params], "gates": [...]} where a
    boxcox, inverseboxcox or sinh_arcsinh member gets the gate
    {a: inv_softplus(1/K), b: 0} and every other member {}."""
    dtype = dtype or cfg.default_dtype()
    device = cfg.resolve_device(device)

    def t(v):
        return torch.tensor(np.asarray(v, dtype=np.float64), dtype=dtype,
                            device=device)

    params = []
    for i, step in enumerate(spec):
        check_step(step)
        ivals = (inits[i] if inits is not None else None) or {}
        if step.kind == "step_flow":
            gate_a = float(np.log(np.expm1(1.0 / len(step.sub))))
            params.append({
                "sub": init_flow_params(step.sub, ivals.get("sub"), dtype,
                                        device),
                "gates": [{"a": t(gate_a), "b": t(0.0)} if s.kind in _GATED
                          else {} for s in step.sub]})
            continue
        defaults = _DEFAULT_INIT.get(step.kind, {})
        if step.kind == "log_exp":
            defaults = {"a": np.ones(step.n_terms), "b": np.ones(step.n_terms),
                        "c": np.zeros(step.n_terms)}
        params.append({pname: t(ivals.get(pname, defaults[pname]))
                       for pname in _SCALAR_PARAMS[step.kind]})
    return params


# ===========================================================================
# Forward / inverse / KLD
# ===========================================================================

def _maybe_pos(x, flag):
    return softplus(x) if flag else x


def _pow_eps(dtype):
    """Floor of |f| before its log in the Box-Cox steps."""
    return 1e-12 if dtype == torch.float32 else 1e-100


def _boxcox_lam(step: FlowStep, lam):
    if step.constraint == "sigmoid2":
        # lam in (0.01, 2.01)
        return 2.0 * torch.sigmoid(lam) + 0.01
    if step.constraint == "sigmoid_ref":
        # lam in (0.05, 2.05); the default raw init 5.0 maps to ~1.05
        return 2.0 * torch.sigmoid(0.3 * lam - 1.5) + 0.05
    return torch.where(lam == 0.0, lam + 1e-11, lam)


def step_forward(step: FlowStep, params, f, X=None, ctx: FlowCtx = FlowCtx()):
    """Apply one flow step elementwise to f (any shape broadcastable with
    the step's parameters)."""
    k = step.kind
    if step.input_dependent:
        raise NotImplementedError(_TODO_HYPER)
    if k == "identity":
        return f
    if k == "exp":
        return safe_exp(f)
    if k == "log":
        return torch.log(f)
    if k == "softplus":
        return softplus(f)
    if k == "softminus":
        return inv_softplus(f + 1e-8)
    if k == "affine":
        a = _maybe_pos(params["a"], step.set_restrictions)
        return a * f + params["b"]
    if k == "translation":
        return f + params["b"]
    if k in ("sinh_arcsinh", "inverse_sinh_arcsinh"):
        a = params["a"]
        b = _maybe_pos(params["b"], step.set_restrictions)
        if k == "sinh_arcsinh":
            fk = safe_sinh(b * torch.asinh(f) - a)
        else:
            fk = safe_sinh((torch.asinh(f) + a) / b)
        return fk + f if step.add_init_f0 else fk
    if k in ("arcsinh", "inverse_arcsinh", "sinh", "tanh"):
        a, c = params["a"], params["c"]
        b = _maybe_pos(params["b"], step.set_restrictions)
        d = _maybe_pos(params["d"], step.set_restrictions)
        if k == "arcsinh":
            fk = a + b * torch.asinh((f - c) / d)
        elif k == "inverse_arcsinh":
            fk = c + d * safe_sinh((f - a) / b)
        elif k == "sinh":
            fk = a + b * safe_sinh((f - c) / d)
        else:
            fk = a + b * safe_tanh((f - c) / d)
        return fk + f if step.add_init_f0 else fk
    if k == "boxcox":
        # the signed power in log space, exp(lam * log|f|) through safe_exp:
        # the floor keeps d/dlam = |f|^lam log|f| finite where |f|
        # underflows, and safe_exp keeps the power below overflow
        lam = _boxcox_lam(step, params["lam"])
        sgn = torch.sign(f)
        pos = torch.clamp_min(sgn * f, _pow_eps(f.dtype))
        fk = (sgn * safe_exp(lam * torch.log(pos)) - 1.0) / lam
        return fk + f if step.add_init_f0 else fk
    if k == "inverseboxcox":
        lam = _boxcox_lam(step, params["lam"])
        aux = lam * f + 1.0
        sgn = torch.sign(aux)
        pos = torch.clamp_min(sgn * aux, _pow_eps(f.dtype))
        fk = sgn * safe_exp(torch.log(pos) / lam)
        return fk + f if step.add_init_f0 else fk
    if k in ("tukey_left", "tukey_right"):
        g = softplus(params["g"])
        if k == "tukey_left":
            g = -g
        h = softplus(params["h"])
        fk = (1.0 / g) * (safe_exp(g * f) - 1.0) * safe_exp(h * torch.square(f) / 2.0)
        return fk + f if step.add_init_f0 else fk
    if k == "normalCDF":
        if step.learnable:
            a, c = params["a"], params["c"]
            b = _maybe_pos(params["b"], step.set_restrictions)
            d = _maybe_pos(params["d"], step.set_restrictions)
        else:
            a, b, c, d = 0.0, 1.0, 0.0, 1.0
        fk = a + b * torch.special.ndtr((f - c) / d)
        return fk + f if step.add_init_f0 else fk
    if k == "log_exp":
        # fk = sum_t softplus(a_t) softplus(softplus(b_t) (f + c_t)), the
        # terms on the parameters' last axis
        res = f if step.add_init_f0 else 0.0
        for t in range(step.n_terms):
            a = softplus(params["a"][..., t])
            b = softplus(params["b"][..., t])
            res = res + a * softplus(b * (f + params["c"][..., t]))
        return res
    if k == "step_flow":
        fk = 0.0
        for sub_step, sub_p, gate in zip(step.sub, params["sub"], params["gates"]):
            g = step_forward(sub_step, sub_p, f, X, ctx)
            if gate:
                fk = fk + softplus(gate["a"]) * g + gate["b"]
            else:
                fk = fk + g
        if step.add_init_f0:
            fk = fk + f
        return fk
    raise ValueError(f"unknown flow kind {k!r}")


def flow_forward(spec: Tuple[FlowStep, ...], params, f, X=None,
                 ctx: FlowCtx = FlowCtx()):
    """Composite forward: apply each step in sequence."""
    for step, p in zip(spec, params):
        f = step_forward(step, p, f, X, ctx)
    return f


# -- analytic inverses where available, Newton otherwise ---------------------

_ANALYTIC_INVERSE = ("identity", "exp", "log", "softplus", "softminus",
                     "affine", "translation", "sinh_arcsinh",
                     "inverse_sinh_arcsinh", "arcsinh", "inverse_arcsinh",
                     "inverseboxcox")


def _step_inverse_analytic(step: FlowStep, params, f):
    k = step.kind
    if k == "identity":
        return f
    if k == "exp":
        return torch.log(f)
    if k == "log":
        return torch.exp(f)
    if k == "softplus":
        return inv_softplus(f + 1e-8)
    if k == "softminus":
        return softplus(f)
    if k == "affine":
        a = _maybe_pos(params["a"], step.set_restrictions)
        return (f - params["b"]) / a
    if k == "translation":
        return f - params["b"]
    if k == "sinh_arcsinh":
        b = _maybe_pos(params["b"], step.set_restrictions)
        return safe_sinh((torch.asinh(f) + params["a"]) / b)
    if k == "inverse_sinh_arcsinh":
        b = _maybe_pos(params["b"], step.set_restrictions)
        return safe_sinh(b * torch.asinh(f) - params["a"])
    if k == "arcsinh":
        b = _maybe_pos(params["b"], step.set_restrictions)
        d = _maybe_pos(params["d"], step.set_restrictions)
        return params["c"] + d * safe_sinh((f - params["a"]) / b)
    if k == "inverse_arcsinh":
        b = _maybe_pos(params["b"], step.set_restrictions)
        d = _maybe_pos(params["d"], step.set_restrictions)
        return params["a"] + b * torch.asinh((f - params["c"]) / d)
    if k == "inverseboxcox":
        lam = _boxcox_lam(step, params["lam"])
        sgn = torch.sign(f)
        return (sgn * torch.pow(sgn * f, lam) - 1.0) / lam
    raise NotImplementedError(k)


def newton_inverse(fwd, target, init=None, iters: int = 100,
                   clamp: float = 1e-4):
    """Solve fwd(x) = target elementwise by Newton-Raphson: a fixed number
    of iterations, the derivative clamped below at `clamp`.

    `fwd` must be elementwise, so the derivative is the gradient of
    sum(fwd(x)).  With grad mode on, the iterations stay in the graph (the
    result is differentiable in fwd's parameters and in target), as the JAX
    package's `fori_loop` is.
    """
    track = torch.is_grad_enabled()
    x = torch.ones_like(target) if init is None else init
    for _ in range(iters):
        with torch.enable_grad():
            xi = x if (track and x.requires_grad) else x.detach().requires_grad_(True)
            val = fwd(xi)
            dval, = torch.autograd.grad(val.sum(), xi, create_graph=track)
        x = xi - (val - target) / torch.clamp_min(dval, clamp)
        if not track:
            x = x.detach()
    return x


def step_inverse(step: FlowStep, params, f, iters: int = 100):
    if step.kind in _ANALYTIC_INVERSE and not step.add_init_f0:
        return _step_inverse_analytic(step, params, f)
    return newton_inverse(lambda x: step_forward(step, params, x), f, iters=iters)


def flow_inverse(spec: Tuple[FlowStep, ...], params, f, iters: int = 100):
    """Composite inverse: invert the steps in reverse order."""
    for step, p in zip(reversed(spec), reversed(params)):
        f = step_inverse(step, p, f, iters)
    return f


def flow_kld(spec: Tuple[FlowStep, ...], params):
    """Sum of the steps' KL terms: zero for point-estimate steps (the VI
    hypernets that have one wait for item 13)."""
    for step in spec:
        check_step(step)
    return torch.zeros((), dtype=cfg.default_dtype())
