"""Marginal normalizing flows as pure functions: the port of the JAX
package's `flows/core.py`.

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

`sinh_arcsinh` and `tanh` also take input-dependent parameters: hypernets
of X (MC-dropout or mean-field-Gaussian VI, `hypernet.py`) give one value
per row, which broadcasts against f (..., Dy, MB) over the quadrature axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import config as cfg
from ..ops.transforms import (inv_softplus, safe_exp, safe_sinh, safe_tanh,
                              softplus)
from .hypernet import (HyperNetSpec, apply_hypernet, finalize_bn_stats,
                       hypernet_kld, init_hypernet)


@dataclasses.dataclass(frozen=True)
class FlowStep:
    kind: str
    set_restrictions: bool = False
    add_init_f0: bool = False
    input_dependent: bool = False
    hypernet: Optional[HyperNetSpec] = None
    constraint: str = "none"          # boxcox: 'none' | 'sigmoid2' | 'sigmoid_ref'
    learnable: bool = True            # normalCDF
    n_terms: int = 1                  # log_exp number of terms
    sub: Tuple["FlowStep", ...] = ()  # step_flow members


@dataclasses.dataclass(frozen=True)
class FlowCtx:
    """Runtime context threaded through flow evaluation.

    `rng` (a torch.Generator on the tensors' device) feeds the hypernets'
    dropout masks and VI noise while `stochastic` is True (training and
    fully-Bayesian evaluation; False is the point estimate).  `mean_only`
    takes the hypernets' deterministic path; `train` puts their batch norm
    in batch-statistics mode.  `draws` is the leading shape of independent
    draws: the hypernets' outputs get shape draws + X.shape[:-1].
    """

    rng: Optional[torch.Generator] = None
    stochastic: bool = True
    mean_only: bool = False
    train: bool = False
    draws: Tuple[int, ...] = ()


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

#: kinds that take hypernet (input-dependent) parameters
_HYPER_CAPABLE = ("sinh_arcsinh", "tanh")


def _hyper_names(step: FlowStep):
    """The parameters that an input-dependent step's hypernets give."""
    return ("a", "b", "c", "d") if step.kind == "tanh" else ("a", "b")


# ===========================================================================
# Spec construction from the generators' list-of-(name, kwargs) format
# ===========================================================================

def _hyper_spec_from_kwargs(kw: dict, kind: str) -> Optional[HyperNetSpec]:
    if not kw.get("input_dependent", False):
        return None
    idc = kw.get("input_dependent_config", {}) or {}
    in_dim = int(kw["input_dim"])
    # the VI prior variance by flow family: 0.5/1e-5 for the 4-parameter
    # tanh flow (a Gaussian prior equivalent to weight decay 1e-5), 1.0 for
    # sinh-arcsinh; unused under MC dropout
    prior_var = 0.5 / 1e-5 if kind == "tanh" else 1.0
    return HyperNetSpec(
        in_dim=in_dim,
        hidden_dim=int(idc.get("hidden_dim", in_dim)),
        num_hidden=int(idc.get("num_hidden_layers", 1)),
        activation=idc.get("hidden_activation", "relu"),
        dropout=float(idc.get("dropout", 0.0)),
        batch_norm=bool(idc.get("batch_norm", 0)),
        inference=idc.get("inference", "MC_dropout"),
        prior_var=prior_var,
    )


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
        add_f0 = bool(kw.get("add_init_f0", False))
        set_res = bool(kw.get("set_restrictions", False)) or add_f0
        hyper = (_hyper_spec_from_kwargs(kw, name)
                 if name in _HYPER_CAPABLE else None)
        constraint = "none"
        if (name in ("boxcox", "inverseboxcox")
                and kw.get("constraint") not in (None, "none")):
            constraint = str(kw["constraint"])
        steps.append(FlowStep(name, set_restrictions=set_res, add_init_f0=add_f0,
                              input_dependent=hyper is not None, hypernet=hyper,
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
    """Raise ValueError for a step that cannot be evaluated: an unknown
    kind, or an input-dependent step of a kind without hypernets or with
    no hypernet spec."""
    if step.input_dependent and (step.kind not in _HYPER_CAPABLE
                                 or step.hypernet is None):
        raise ValueError(f"{step.kind!r} step cannot be input-dependent "
                         f"(hypernet {step.hypernet})")
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
                     device=None, generator=None):
    """Parameter list (one dict per step) for `spec`, with the JAX
    package's defaults: 0-d tensors, `log_exp`'s (n_terms,) vectors, and
    for a step_flow {"sub": [member params], "gates": [...]} where a
    boxcox, inverseboxcox or sinh_arcsinh member gets the gate
    {a: inv_softplus(1/K), b: 0} and every other member {}.

    An input-dependent step also gets its hypernets ("net_a", "net_b", and
    for tanh "net_c", "net_d"), drawn in that order from the CPU generator
    `generator` (None: one seeded with `config.config_seed`); its scalar
    parameters stay as the anchors that the hypernet initializer fits the
    nets to, frozen in training.  The JAX package draws the nets from
    threefry keys, which torch cannot reproduce: `weights.params_from_jax`
    loads a JAX init."""
    dtype = dtype or cfg.default_dtype()
    device = cfg.resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.config_seed)

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
                                        device, generator),
                "gates": [{"a": t(gate_a), "b": t(0.0)} if s.kind in _GATED
                          else {} for s in step.sub]})
            continue
        defaults = _DEFAULT_INIT.get(step.kind, {})
        if step.kind == "log_exp":
            defaults = {"a": np.ones(step.n_terms), "b": np.ones(step.n_terms),
                        "c": np.zeros(step.n_terms)}
        p = {pname: t(ivals.get(pname, defaults[pname]))
             for pname in _SCALAR_PARAMS[step.kind]}
        if step.input_dependent:
            for n in _hyper_names(step):
                p[f"net_{n}"] = init_hypernet(step.hypernet, generator, dtype,
                                              device)
        params.append(p)
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


def _rewind(ctx: FlowCtx, steps):
    """A function that puts the generator `ctx.rng` back to its present
    state, where `steps` hold a stochastic hypernet (else a no-op).

    The JAX package hands every member of a step_flow, and every step of
    the hypernet initializer's loss, the same key, so their nets draw the
    same masks (for equal shapes); rewinding the generator before each one
    does the same here."""
    def drawing(s):
        return (s.input_dependent and (s.hypernet.dropout > 0.0 or
                                       s.hypernet.inference != "MC_dropout")
                or any(drawing(m) for m in s.sub))
    if ctx.rng is None or not ctx.stochastic or not any(map(drawing, steps)):
        return lambda: None
    state = ctx.rng.get_state()
    return lambda: ctx.rng.set_state(state)


def _hyper_params(step: FlowStep, params, X, ctx: FlowCtx, names):
    """The step's hypernets evaluated on X: one tensor per name, of shape
    X.shape[:-1] (draws + X.shape[:-1] while drawing)."""
    return [apply_hypernet(step.hypernet, params[f"net_{n}"], X, rng=ctx.rng,
                           stochastic=ctx.stochastic, mean_only=ctx.mean_only,
                           train=ctx.train, draws=ctx.draws)
            for n in names]


def finalize_bn(spec: Tuple[FlowStep, ...], params, X):
    """Recalibrate the batch-norm statistics of every hypernet of the flow
    from a deterministic pass over X (`hypernet.finalize_bn_stats`).
    Returns a new params list; a no-op for flows without BN hypernets."""
    out = []
    for step, p in zip(spec, params):
        if step.kind == "step_flow":
            out.append(dict(p, sub=finalize_bn(step.sub, p["sub"], X)))
            continue
        if step.input_dependent and step.hypernet.batch_norm:
            p = dict(p)
            for n in _hyper_names(step):
                p[f"net_{n}"] = finalize_bn_stats(step.hypernet,
                                                  p[f"net_{n}"], X)
        out.append(p)
    return out


def step_forward(step: FlowStep, params, f, X=None, ctx: FlowCtx = FlowCtx()):
    """Apply one flow step elementwise to f (any shape broadcastable with
    the step's parameters).  An input-dependent step evaluates its
    hypernets on X (..., MB, Dx), whose per-row values broadcast against
    f's trailing axes."""
    k = step.kind
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
        if step.input_dependent and k == "sinh_arcsinh":
            a, b = _hyper_params(step, params, X, ctx, ("a", "b"))
        else:
            a, b = params["a"], params["b"]
        b = _maybe_pos(b, step.set_restrictions)
        if k == "sinh_arcsinh":
            fk = safe_sinh(b * torch.asinh(f) - a)
        else:
            fk = safe_sinh((torch.asinh(f) + a) / b)
        return fk + f if step.add_init_f0 else fk
    if k in ("arcsinh", "inverse_arcsinh", "sinh", "tanh"):
        if step.input_dependent and k == "tanh":
            a, b, c, d = _hyper_params(step, params, X, ctx, ("a", "b", "c", "d"))
        else:
            a, b, c, d = params["a"], params["b"], params["c"], params["d"]
        b = _maybe_pos(b, step.set_restrictions)
        d = _maybe_pos(d, step.set_restrictions)
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
        rewind = _rewind(ctx, step.sub)
        for sub_step, sub_p, gate in zip(step.sub, params["sub"], params["gates"]):
            rewind()
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
    """Composite forward: apply each step in sequence (the hypernets of
    every step draw from the one generator `ctx.rng`, in step order)."""
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


def value_and_derivative(fn, x):
    """(fn(x), dfn/dx) of an elementwise fn, the derivative as the gradient
    of sum(fn(x)) by `torch.func.grad`, which runs inside a
    `torch.func.vmap` as well (the battery's map refuses
    `requires_grad_`).  With grad mode on, both stay differentiable in x
    and in fn's parameters; under no_grad they come back without history."""
    def total(y):
        val = fn(y)
        return val.sum(), val

    dval, val = torch.func.grad(total, has_aux=True)(x)
    return val, dval


def newton_inverse(fwd, target, init=None, iters: int = 100,
                   clamp: float = 1e-4):
    """Solve fwd(x) = target elementwise by Newton-Raphson: a fixed number
    of iterations, the derivative clamped below at `clamp`.

    `fwd` must be elementwise (`value_and_derivative`).  With grad mode on,
    the iterations stay in the graph (the result is differentiable in fwd's
    parameters and in target), as the JAX package's `fori_loop` is.
    """
    x = torch.ones_like(target) if init is None else init
    for _ in range(iters):
        val, dval = value_and_derivative(fwd, x)
        x = x - (val - target) / torch.clamp_min(dval, clamp)
    return x


def step_inverse(step: FlowStep, params, f, iters: int = 100):
    if (step.kind in _ANALYTIC_INVERSE and not step.add_init_f0
            and not step.input_dependent):
        return _step_inverse_analytic(step, params, f)
    return newton_inverse(lambda x: step_forward(step, params, x), f, iters=iters)


def flow_inverse(spec: Tuple[FlowStep, ...], params, f, iters: int = 100):
    """Composite inverse: invert the steps in reverse order."""
    for step, p in zip(reversed(spec), reversed(params)):
        f = step_inverse(step, p, f, iters)
    return f


def flow_kld(spec: Tuple[FlowStep, ...], params):
    """Sum of the steps' KL terms: non-zero only for VI hypernets (over
    every output of stacked per-output params)."""
    total = torch.zeros((), dtype=cfg.default_dtype())
    for step, p in zip(spec, params):
        check_step(step)
        if step.kind == "step_flow":
            total = total + flow_kld(step.sub, p["sub"])
        elif (step.input_dependent
              and step.hypernet.inference == "mean_field_gaussian"):
            for n in _hyper_names(step):
                total = total + hypernet_kld(step.hypernet, p[f"net_{n}"])
    return total


def flow_forward_initializer(spec: Tuple[FlowStep, ...], params, X,
                             ctx: FlowCtx = FlowCtx()):
    """The hypernet initializer's loss: the sum over input-dependent steps
    and their nets of mean((net(X) - anchor)^2), with the anchor (the
    step's scalar parameter) held constant.

    Both inference modes fit through the stochastic forward (dropout on,
    VI weights sampled): the sampled pass is what drives the VI logvars
    down from their variance-1 init before the ELBO sees them.  Every
    input-dependent step starts from the same generator state (see
    `_rewind`).
    """
    sctx = dataclasses.replace(ctx, stochastic=True, mean_only=False)
    rewind = _rewind(sctx, spec)

    def walk(steps, ps):
        loss = torch.zeros((), dtype=X.dtype, device=X.device)
        for step, p in zip(steps, ps):
            if step.kind == "step_flow":
                loss = loss + walk(step.sub, p["sub"])
                continue
            if not step.input_dependent:
                continue
            rewind()
            names = _hyper_names(step)
            for n, out in zip(names, _hyper_params(step, p, X, sctx, names)):
                loss = loss + torch.mean(torch.square(out - p[n].detach()))
        return loss

    return walk(spec, params)
