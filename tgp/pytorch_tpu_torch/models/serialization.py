"""Spec (de)serialization: the port's specs to and from the plain dicts and
JSON of the JAX package's `models/serialization.py`, deep specs included.

A dict written by either package reads in the other: the keys, their order
of nesting and the defaults of the keys that older dicts lack are the JAX
package's.
"""

from __future__ import annotations

import dataclasses
import json

from ..flows.core import FlowStep
from ..flows.hypernet import HyperNetSpec
from ..likelihoods.gaussian import LikelihoodSpec
from ..ops.kernels import KernelSpec
from . import deep
from .tgp import TGPSpec, check_spec


def _kernel_to_dict(k: KernelSpec):
    return {"kind": k.kind, "ard": k.ard,
            "children": [_kernel_to_dict(c) for c in k.children]}


def _kernel_from_dict(d) -> KernelSpec:
    return KernelSpec(d["kind"], tuple(_kernel_from_dict(c) for c in d["children"]),
                      d.get("ard", True))


def _step_to_dict(s: FlowStep):
    return {"kind": s.kind, "set_restrictions": s.set_restrictions,
            "add_init_f0": s.add_init_f0, "input_dependent": s.input_dependent,
            "hypernet": (None if s.hypernet is None
                         else dataclasses.asdict(s.hypernet)),
            "constraint": s.constraint, "learnable": s.learnable,
            "n_terms": s.n_terms, "sub": [_step_to_dict(x) for x in s.sub]}


def _step_from_dict(d) -> FlowStep:
    hyper = None if d["hypernet"] is None else HyperNetSpec(**d["hypernet"])
    return FlowStep(d["kind"], d["set_restrictions"], d["add_init_f0"],
                    d["input_dependent"], hyper, d["constraint"],
                    d["learnable"], d["n_terms"],
                    tuple(_step_from_dict(x) for x in d["sub"]))


def _lik_to_dict(l: LikelihoodSpec):
    return {"kind": l.kind, "out_dim": l.out_dim,
            "noise_is_shared": l.noise_is_shared, "quad_points": l.quad_points,
            "num_classes": l.num_classes,
            "warp_flow": [_step_to_dict(s) for s in l.warp_flow]}


def _lik_from_dict(d) -> LikelihoodSpec:
    return LikelihoodSpec(d["kind"], d["out_dim"], d["noise_is_shared"],
                          d["quad_points"], d["num_classes"],
                          tuple(_step_from_dict(s) for s in d["warp_flow"]))


def spec_to_dict(spec) -> dict:
    if deep.is_deep(spec):
        return {"deep": True,
                "layers": [spec_to_dict(l) for l in spec.layers],
                "S_train": spec.S_train, "S_test": spec.S_test}
    return {
        "Dy": spec.Dy, "Dx": spec.Dx, "M": spec.M, "N": spec.N,
        "kernel": _kernel_to_dict(spec.kernel),
        "likelihood": _lik_to_dict(spec.likelihood),
        "flow": [_step_to_dict(s) for s in spec.flow],
        "flow_per_output": (None if spec.flow_per_output is None else
                            [[_step_to_dict(s) for s in f]
                             for f in spec.flow_per_output]),
        "mean": spec.mean, "whiten": spec.whiten,
        "Z_is_shared": spec.Z_is_shared, "K_is_shared": spec.K_is_shared,
        "mean_is_shared": spec.mean_is_shared,
        "q_U_is_shared": spec.q_U_is_shared,
        "flow_is_shared": spec.flow_is_shared,
        "min_var": spec.min_var, "remat": spec.remat,
        "fast_solves": spec.fast_solves,
        "solve_precision": spec.solve_precision,
    }


def spec_from_dict(d: dict):
    """A `TGPSpec`, or a `DeepTGPSpec` for a dict with "deep"; raises
    NotImplementedError for a part the port does not cover yet."""
    if d.get("deep"):
        spec = deep.DeepTGPSpec(
            layers=tuple(spec_from_dict(l) for l in d["layers"]),
            S_train=d["S_train"], S_test=d["S_test"])
        check_spec(spec)
        return spec
    spec = TGPSpec(
        Dy=d["Dy"], Dx=d["Dx"], M=d["M"], N=d["N"],
        kernel=_kernel_from_dict(d["kernel"]),
        likelihood=_lik_from_dict(d["likelihood"]),
        flow=tuple(_step_from_dict(s) for s in d["flow"]),
        flow_per_output=(None if d.get("flow_per_output") is None else
                         tuple(tuple(_step_from_dict(s) for s in f)
                               for f in d["flow_per_output"])),
        mean=d["mean"], whiten=d["whiten"],
        Z_is_shared=d["Z_is_shared"], K_is_shared=d["K_is_shared"],
        mean_is_shared=d["mean_is_shared"], q_U_is_shared=d["q_U_is_shared"],
        flow_is_shared=d["flow_is_shared"], min_var=d["min_var"],
        remat=d.get("remat", False),
        fast_solves=d.get("fast_solves", False),
        solve_precision=d.get("solve_precision", "highest"),
    )
    check_spec(spec)
    return spec


def spec_to_json(spec) -> str:
    return json.dumps(spec_to_dict(spec))


def spec_from_json(s: str):
    return spec_from_dict(json.loads(s))
