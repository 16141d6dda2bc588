"""Flow-architecture construction for the experiment layer: the sweep
tables (`exp_config`) routed to generator calls, as the repo's
`experiments/flow_arch.py` routes them for the JAX package.  The caller
keeps the identity fit of the Step* archs, which depends on the split's data.
"""

from __future__ import annotations

from ..flows import generators as G, spec_from_list
from . import exp_config as EC

#: point-estimate generators that take (num_blocks) only
_PLAIN_ARCHS = ("SAL", "ArcSL", "BoxCoxL", "InverseBoxCoxL", "Affine")


def resolve_tgp_arch(dataset: str, is_class: bool = False,
                     arch_override=None, num_blocks=None):
    """(arch, nb, ns) for a TGP run: the sweep-table row, optionally
    overridden by ('Name', nb, ns) or a num_blocks replacement."""
    if arch_override is not None:
        arch, nb, ns = arch_override
    else:
        table = (EC.TGP_CLASSIFICATION_SWEEP if is_class
                 else EC.TGP_REGRESSION_SWEEP)
        arch, nb, ns = table[dataset]
    if num_blocks:
        nb = num_blocks
    if arch.startswith("Step") and ns is None and arch != "StepAllL":
        raise ValueError(f"arch {arch}:{nb} needs NUM_STEPS "
                         f"({arch}:{nb}:<steps>)")
    return arch, nb, ns


def parse_arch_flag(value: str):
    """'NAME:NB[:NS]' CLI override -> (arch, nb, ns)."""
    parts = value.split(":")
    return (parts[0], int(parts[1]),
            int(parts[2]) if len(parts) > 2 else None)


def is_step_arch(arch: str) -> bool:
    return arch.startswith("Step")


def make_step_gen(arch: str, nb: int, ns):
    """Zero-arg builder of a fresh Step* flow list (each call draws new
    inits, as the identity fit's restarts require)."""
    gen = getattr(G, arch)
    if ns is None:
        return lambda: gen(nb, add_f0=True)
    return lambda: gen(nb, ns, add_f0=True)


def build_point_flow(arch: str, nb: int):
    """(flow_spec, flow_inits) for the non-Step point-estimate archs: plain
    generators, chains like SAL_BCL, or `rand_<name>` randomly-initialised
    single flows repeated nb times."""
    if arch.startswith("rand_"):
        return spec_from_list(G.random_flow([arch[len("rand_"):]] * nb))
    if arch in _PLAIN_ARCHS:
        return spec_from_list(getattr(G, arch)(nb))
    return spec_from_list(G.build_chain(arch, nb))


def build_id_flow(dataset: str, Dx: int, is_class: bool = False,
                  inference: str = "MC_dropout"):
    """(flow_spec, flow_inits) for the ID_TGP hypernet arch of `dataset`
    (the ID sweep table: blocks, activation, hidden layers, dropout, batch
    norm, width).  inference='mean_field_gaussian' swaps the MC-dropout nets
    for VI nets, with dropout 0."""
    table = (EC.ID_TGP_CLASSIFICATION_SWEEP if is_class
             else EC.ID_TGP_REGRESSION_SWEEP)
    nb, act, nh, dr, bn, width = table[dataset]
    if inference == "mean_field_gaussian":
        dr = 0.0
    return spec_from_list(G.SAL(
        nb, input_dependent=True, input_dim=Dx, hidden_activation=act,
        num_hidden_layers=nh, dropout=dr, batch_norm=bn, hidden_dim=width,
        inference=inference))
