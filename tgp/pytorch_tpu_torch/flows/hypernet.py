"""Hypernetworks producing input-dependent flow parameters: the port of the
JAX package's `flows/hypernet.py`.

Two inference modes:
  * 'MC_dropout': a plain MLP with dropout after each hidden activation;
    dropout stays on at evaluation when the model is run fully Bayesian
    (the MC-dropout posterior).
  * 'mean_field_gaussian': a mean-field Gaussian VI network sampled with the
    local reparameterisation trick, with a closed-form KL added to the ELBO.

Hidden layers are Linear -> (batch norm) -> activation -> dropout; the last
layer is linear to one scalar per input row.  The MLPs are `torch.matmul`
and ATen elementwise ops, as the JAX package leaves them to XLA.

Layouts.  X is (..., rows, in_dim) and the output has X's leading shape.
A net's parameters are either one net's (W (din, dout), vectors (dout,)) or
one net per output stacked on a leading Dy axis (W (Dy, din, dout), vectors
(Dy, dout)) against X (Dy, rows, in_dim): `torch.matmul` broadcasts W over
the outputs, and `_row` gives a stacked vector the row axis.

Random draws.  Every draw (the dropout keep-masks and the VI noise) goes
through `_draw`, one per net and layer, with the shape `draws + rows +
(width,)`: one mask per input row, shared by everything the row's parameter
is broadcast against (the quadrature nodes of f), and drawn independently
per output, net and layer.  `draws` puts independent draws on leading axes,
so S Monte Carlo flow draws cost one batched op each and no Python loop.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..ops.transforms import safe_tanh


ACTS = {
    "relu": torch.relu,
    "tanh": safe_tanh,
    # jax.nn.gelu's default is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid,
    "linear": lambda x: x,
}


@dataclasses.dataclass(frozen=True)
class HyperNetSpec:
    """Static hypernet architecture (the JAX package's fields and
    defaults: one hidden layer of width in_dim, relu, MC dropout)."""

    in_dim: int
    hidden_dim: int
    num_hidden: int = 1
    activation: str = "relu"
    dropout: float = 0.0
    batch_norm: bool = False
    inference: str = "MC_dropout"  # or 'mean_field_gaussian'
    prior_var: float = 1.0         # VI prior variance

    def __post_init__(self):
        if self.batch_norm and self.inference != "MC_dropout":
            raise NotImplementedError(
                "batch_norm is only supported for MC_dropout hypernets")

    def layer_dims(self) -> Tuple[Tuple[int, int], ...]:
        """(din, dout) per linear layer, ending in the scalar output.  VI
        nets are one hidden layer deeper than MC-dropout nets at the same
        num_hidden."""
        n_hidden = self.num_hidden
        if self.inference == "mean_field_gaussian":
            n_hidden += 1
        dims = []
        d = self.in_dim
        for _ in range(n_hidden):
            dims.append((d, self.hidden_dim))
            d = self.hidden_dim
        dims.append((d, 1))
        return tuple(dims)


def init_hypernet(spec: HyperNetSpec, generator: torch.Generator, dtype,
                  device):
    """One net's parameters, drawn from `generator` (a CPU generator: the
    values are drawn in float64 on the host, so the card and the CPU start
    from the same net): Kaiming-uniform W and b in +-1/sqrt(din) and BN
    gamma=1, beta=0, mean=0, var=1 for MC dropout; means ~ N(0, 1) and
    logvars ~ N(0, 1) * -1e-20 for VI."""
    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, dtype=torch.float64)
        return (2.0 * bound) * u - bound

    def normal(shape):
        return torch.randn(shape, generator=generator, dtype=torch.float64)

    layers = []
    n = len(spec.layer_dims())
    for i, (din, dout) in enumerate(spec.layer_dims()):
        if spec.inference == "MC_dropout":
            bound = 1.0 / din ** 0.5
            layer = {"W": uniform((din, dout), bound),
                     "b": uniform((dout,), bound)}
            if spec.batch_norm and i < n - 1:
                layer["bn"] = {"gamma": torch.ones(dout), "beta": torch.zeros(dout),
                               "mean": torch.zeros(dout), "var": torch.ones(dout)}
        elif spec.inference == "mean_field_gaussian":
            layer = {"w_mean": normal((din, dout)),
                     "w_logvar": normal((din, dout)) * -1e-20,
                     "b_mean": normal((dout,)),
                     "b_logvar": normal((dout,)) * -1e-20}
        else:
            raise NotImplementedError(spec.inference)
        layers.append({k: (v.to(device, dtype) if k != "bn" else
                           {s: t.to(device, dtype) for s, t in v.items()})
                       for k, v in layer.items()})
    return {"layers": layers}


LOGVAR_CAP = 30.0


def _exp_lin(lv, cap=LOGVAR_CAP):
    """exp with a linear tail past `cap`: finite in fp32 while keeping a
    positive derivative, so the KL can still pull a runaway logvar back.
    The sampled variance and the KL both use it."""
    return torch.where(lv > cap, math.exp(cap) * (1.0 + (lv - cap)),
                       torch.exp(torch.clamp(lv, max=cap)))


def _row(v):
    """A per-layer vector (dout,) as it is, or stacked per output (Dy, dout)
    as (Dy, 1, dout), to broadcast against h (..., Dy, rows, dout)."""
    return v if v.ndim == 1 else v.unsqueeze(-2)


class ReplicaGenerators:
    """One `torch.Generator` per replica, for a function that
    `torch.func.vmap` maps over R replicas (the multi-seed battery), which
    refuses a generator's draws inside the map.  `bind(token)` ties the
    generators to a mapped tensor (any tensor that the map batches, one
    entry a replica); a draw through the bound object is R draws, replica
    r's from generator r, made outside the map and stacked: replica r gets
    what a single model drawing from generator r would get."""

    def __init__(self, gens, token=None):
        self.gens = list(gens)
        self.token = token

    def bind(self, token) -> "ReplicaGenerators":
        return ReplicaGenerators(self.gens, token)

    def get_state(self):
        return [g.get_state() for g in self.gens]

    def set_state(self, states):
        for g, st in zip(self.gens, states):
            g.set_state(st)


class _ReplicaDraw(torch.autograd.Function):
    """fn(generator) for each replica's generator, stacked on the mapped
    axis; outside a map, fn of the generator that `token` names."""

    @staticmethod
    def forward(token, rngs, fn):
        return fn(rngs.gens[int(token)])

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, token, rngs, fn):
        if in_dims[0] is None or info.batch_size != len(rngs.gens):
            raise ValueError(f"{len(rngs.gens)} replica generators under a "
                             f"map of {info.batch_size}")
        return torch.stack([fn(g) for g in rngs.gens]), 0


def _generate(fn, generator):
    """fn(generator), or per replica for `ReplicaGenerators`."""
    if isinstance(generator, ReplicaGenerators):
        return _ReplicaDraw.apply(generator.token, generator, fn)
    return fn(generator)


class DeviceDraws:
    """A `torch.Generator` whose draws are made on its own device and then
    moved to the device that the caller asks for: evaluation on the host CPU
    of a model trained on the card (`Trainer.eval_device = "cpu"`) draws
    from the Trainer's one generator, so the stream stays one and the card's
    and the host's evaluations see the same draws."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def get_state(self):
        return self.gen.get_state()

    def set_state(self, state):
        self.gen.set_state(state)


def with_generator(fn, x, generator):
    """fn(x, generator) for a draw shaped by a tensor x (bernoulli,
    multinomial); under `DeviceDraws`, x goes to the generator's device and
    the draw comes back to x's."""
    if isinstance(generator, DeviceDraws):
        return fn(x.to(generator.gen.device), generator.gen).to(x.device)
    return fn(x, generator)


def _draw(kind: str, shape, p, generator: torch.Generator, dtype, device):
    """Every random draw of the hypernets: kind 'keep' a dropout keep-mask,
    True with probability p; kind 'normal' standard-normal VI noise (p is
    unused).  `generator` may be `ReplicaGenerators` or `DeviceDraws`."""
    if isinstance(generator, DeviceDraws):
        return _draw(kind, shape, p, generator.gen, dtype,
                     generator.gen.device).to(device)
    if kind == "keep":
        return _generate(lambda g: torch.rand(
            shape, generator=g, dtype=dtype, device=device) < p, generator)
    return randn(shape, generator, dtype, device)


def randn(shape, generator, dtype, device):
    """Standard normals from a `torch.Generator`, `ReplicaGenerators` or
    `DeviceDraws`."""
    if isinstance(generator, DeviceDraws):
        return randn(shape, generator.gen, dtype,
                     generator.gen.device).to(device)
    return _generate(lambda g: torch.randn(shape, generator=g, dtype=dtype,
                                           device=device), generator)


def _batch_norm(layer_bn, h, use_batch_stats: bool, eps: float = 1e-5):
    """Batch norm over the row axis of h (..., rows, dout).

    use_batch_stats=True normalises with the batch's own statistics
    (biased variance, as `jnp.var`); False uses the stored ones.  The
    statistics are per output, which the JAX package gets by vmapping over
    the outputs."""
    if use_batch_stats:
        mean = torch.mean(h, dim=-2, keepdim=True)
        var = torch.var(h, dim=-2, keepdim=True, correction=0)
    else:
        mean, var = _row(layer_bn["mean"]), _row(layer_bn["var"])
    return (_row(layer_bn["gamma"]) * (h - mean) / torch.sqrt(var + eps)
            + _row(layer_bn["beta"]))


def apply_hypernet(spec: HyperNetSpec, params, X, *, rng=None,
                   stochastic: bool = True, mean_only: bool = False,
                   train: bool = False, draws: Tuple[int, ...] = ()):
    """Forward X (..., rows, in_dim) -> one flow parameter per row.

    stochastic=True keeps dropout / weight sampling on (training or MC
    evaluation), with the draws from the torch.Generator `rng`; the result
    then has the shape draws + X.shape[:-1].  mean_only=True takes the
    deterministic path.  train=True puts batch norm in batch-statistics
    mode (ELBO training only; evaluation uses the stored statistics).
    """
    act = ACTS[spec.activation]
    rows = tuple(X.shape[:-1])
    draws = tuple(draws)
    n_layers = len(params["layers"])
    h = X
    for i, layer in enumerate(params["layers"]):
        last = i == n_layers - 1
        if spec.inference == "MC_dropout":
            h = torch.matmul(h, layer["W"]) + _row(layer["b"])
            if not last:
                if spec.batch_norm:
                    h = _batch_norm(layer["bn"], h, use_batch_stats=train)
                h = act(h)
                if spec.dropout > 0.0 and stochastic and not mean_only:
                    if rng is None:
                        raise ValueError("dropout requires an rng")
                    keep = _draw("keep", draws + rows + (h.shape[-1],),
                                 1.0 - spec.dropout, rng, h.dtype, h.device)
                    h = torch.where(keep, h / (1.0 - spec.dropout), 0.0)
        else:  # mean_field_gaussian with the local reparameterisation
            mu = torch.matmul(h, layer["w_mean"]) + _row(layer["b_mean"])
            if mean_only or not stochastic:
                s = mu
            else:
                var = (torch.matmul(torch.square(h), _exp_lin(layer["w_logvar"]))
                       + _row(_exp_lin(layer["b_logvar"])))
                if rng is None:
                    raise ValueError("VI hypernet sampling requires an rng")
                eps = _draw("normal", draws + rows + (var.shape[-1],), None,
                            rng, h.dtype, h.device)
                s = mu + eps * torch.sqrt(var)
            h = s if last else act(s)
    return torch.squeeze(h, -1)


def finalize_bn_stats(spec: HyperNetSpec, params, X):
    """Set each BN layer's stored mean and var from a deterministic pass
    over X (dropout off, earlier BN layers already using their new
    statistics).  Returns new params; the stored statistics keep their
    shapes, (dout,) or stacked (Dy, dout)."""
    if spec.inference != "MC_dropout" or not spec.batch_norm:
        return params
    act = ACTS[spec.activation]
    n_layers = len(params["layers"])
    new_layers = []
    h = X
    for i, layer in enumerate(params["layers"]):
        last = i == n_layers - 1
        h = torch.matmul(h, layer["W"]) + _row(layer["b"])
        if not last and "bn" in layer:
            bn = dict(layer["bn"], mean=torch.mean(h, dim=-2),
                      var=torch.var(h, dim=-2, correction=0))
            layer = dict(layer, bn=bn)
            h = _batch_norm(bn, h, use_batch_stats=False)
        new_layers.append(layer)
        if not last:
            h = act(h)
    return dict(params, layers=new_layers)


def hypernet_kld(spec: HyperNetSpec, params):
    """KL(q(w) || N(0, prior_var)) summed over every layer (and every
    output of stacked params); 0 for MC dropout, whose regulariser is the
    optimizer's weight decay."""
    ref = params["layers"][0]
    ref = ref.get("W", ref.get("w_mean"))
    if spec.inference != "mean_field_gaussian":
        return torch.zeros((), dtype=ref.dtype, device=ref.device)
    p_logvar = math.log(spec.prior_var)
    total = 0.0
    for layer in params["layers"]:
        for m_key, lv_key in (("w_mean", "w_logvar"), ("b_mean", "b_logvar")):
            q_m, q_lv = layer[m_key], layer[lv_key]
            total = total + 0.5 * torch.sum(
                -1.0 + p_logvar - q_lv + _exp_lin(q_lv) / spec.prior_var
                + torch.square(q_m) / spec.prior_var)
    return total
