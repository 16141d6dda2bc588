"""Flow-architecture generators: the port's copy of the JAX package's
`flows/generators.py`.

Spec builders returning `[('name', init_kwargs), ...]` lists consumed by
`spec_from_list`, with the same identity-at-init values:
  * SAL   : sinh-arcsinh (a=0, b=1) + affine (a=1, b=0)
  * BoxCoxL / InverseBoxCoxL : lam=5 + affine
  * ArcSL : arcsinh (randn, b,d shifted +1) + affine
  * Affine
  * StepTanhL / StepSAL / StepArcSL / StepBoxCoxL / StepInverseBoxCoxL /
    StepAllL : positive linear combinations with randomized per-step inits
    (each step must start different or their gradients collapse).

Randomized inits draw numpy's global RNG in exactly the JAX package's
order, so a seeded run starts from the same point in both packages.
SAL and StepTanhL take input-dependent steps (input_dependent=True with
input_dim and the hypernet options), as the JAX package's do.
"""

from __future__ import annotations

import numpy as np

from ..ops.transforms import np_inv_softplus


def _common(options):
    return (options.get("set_res", False), options.get("add_f0", False),
            options.get("init_random", False), options.get("constraint", None))


def _input_dependent(options):
    """The hypernet fields that SAL and StepTanhL write into their steps:
    (input_dependent, input_dim, config)."""
    input_dependent = bool(options.get("input_dependent", False))
    input_dim = options.get("input_dim", -1)
    if input_dependent and not input_dim > 0:
        raise ValueError("input-dependent flows need input_dim > 0")
    idc = {}
    for k in ("batch_norm", "dropout", "hidden_dim", "hidden_activation",
              "num_hidden_layers", "inference"):
        if k in options:
            idc[k] = options[k]
    return input_dependent, input_dim, idc


def SAL(num_blocks, **kwargs):
    """sinh-arcsinh + affine blocks."""
    set_res, addf0, init_random, _ = _common(kwargs)
    input_dependent, input_dim, idc = _input_dependent(kwargs)
    blocks = []
    for _ in range(num_blocks):
        if init_random:
            a_aff, b_aff = np.random.randn(2)
            a_sal, b_sal = np.random.randn(2)
        else:
            a_aff, b_aff = 1.0, 0.0
            a_sal, b_sal = 0.0, 1.0
        blocks += [
            ("sinh_arcsinh", {"init_a": a_sal, "init_b": b_sal,
                              "add_init_f0": addf0, "set_restrictions": set_res,
                              "input_dependent": input_dependent,
                              "input_dim": input_dim,
                              "input_dependent_config": idc}),
            ("affine", {"init_a": a_aff, "init_b": b_aff,
                        "set_restrictions": set_res}),
        ]
    return blocks


def BoxCoxL(num_blocks, **kwargs):
    """boxcox + affine.  The default constraint 'sigmoid_ref' bounds lam to
    (0.05, 2.05), so the default raw init 5.0 is near the identity."""
    set_res, addf0, init_random, constraint = _common(kwargs)
    if "constraint" not in kwargs:
        constraint = "sigmoid_ref"
    blocks = []
    for _ in range(num_blocks):
        if init_random:
            a_aff, b_aff = np.random.randn(2)
            lam = float(np.random.randn(1)[0] + 1.0)
            constraint = None
        else:
            a_aff, b_aff = 1.0, 0.0
            lam = 5.0
        blocks += [
            ("boxcox", {"init_lam": lam, "add_init_f0": addf0,
                        "constraint": constraint}),
            ("affine", {"init_a": a_aff, "init_b": b_aff,
                        "set_restrictions": set_res}),
        ]
    return blocks


def InverseBoxCoxL(num_blocks, **kwargs):
    """inverse boxcox + affine; the default constraint as BoxCoxL."""
    set_res, addf0, init_random, constraint = _common(kwargs)
    if "constraint" not in kwargs:
        constraint = "sigmoid_ref"
    blocks = []
    for _ in range(num_blocks):
        if init_random:
            a_aff, b_aff = np.random.randn(2)
            lam = float(np.random.randn(1)[0] + 1.0)
        else:
            a_aff, b_aff = 1.0, 0.0
            lam = 5.0
        blocks += [
            ("inverseboxcox", {"init_lam": lam, "add_init_f0": addf0,
                               "constraint": constraint}),
            ("affine", {"init_a": a_aff, "init_b": b_aff,
                        "set_restrictions": set_res}),
        ]
    return blocks


def ArcSL(num_blocks, **kwargs):
    """arcsinh + affine."""
    set_res, addf0, init_random, _ = _common(kwargs)
    blocks = []
    for _ in range(num_blocks):
        if init_random:
            a_aff, b_aff = np.random.randn(2)
            a, b, c, d = np.random.randn(4)
        else:
            a_aff, b_aff = 1.0, 0.0
            a, b, c, d = np.random.randn(4)
            b += 1
            d += 1
        blocks += [
            ("arcsinh", {"init_a": a, "init_b": b, "init_c": c, "init_d": d,
                         "add_init_f0": addf0, "set_restrictions": set_res}),
            ("affine", {"init_a": a_aff, "init_b": b_aff,
                        "set_restrictions": set_res}),
        ]
    return blocks


def Affine(num_blocks, **kwargs):
    set_res, addf0, init_random, _ = _common(kwargs)
    blocks = []
    for _ in range(num_blocks):
        a, b = np.random.randn(2) if init_random else (1.0, 0.0)
        blocks.append(("affine", {"init_a": a, "init_b": b,
                                  "set_restrictions": set_res}))
    return blocks


def _step_block(step_specs, addf0, init_random):
    a_aff, b_aff = np.random.randn(2) if init_random else (1.0, 0.0)
    return [
        ("step_flow", {"flow_arr": step_specs, "add_init_f0": addf0}),
        ("affine", {"init_a": a_aff, "init_b": b_aff, "set_restrictions": False}),
    ]


def StepTanhL(num_blocks, num_steps, **kwargs):
    """Linear combination of tanh steps + affine:
    sum_i a*[a_i + b_i tanh((f-c_i)/d_i)] + b."""
    set_res, addf0, init_random, _ = _common(kwargs)
    input_dependent, input_dim, idc = _input_dependent(kwargs)
    blocks = []
    for _ in range(num_blocks):
        steps = []
        for _ in range(num_steps):
            e1, e2, e3, e4 = np.random.randn(4)
            if not init_random:
                e2 = float(np_inv_softplus(abs((e2 + 1.0) / num_steps)))
                e4 = float(np_inv_softplus(abs((e4 + 1.0) / num_steps)))
            steps.append(("tanh", {"init_a": e1, "init_b": e2, "init_c": e3,
                                   "init_d": e4, "add_init_f0": False,
                                   "set_restrictions": True,
                                   "input_dependent": input_dependent,
                                   "input_dim": input_dim,
                                   "input_dependent_config": idc}))
        blocks += _step_block(steps, addf0, init_random)
    return blocks


def StepSAL(num_blocks, num_steps, **kwargs):
    set_res, addf0, init_random, _ = _common(kwargs)
    blocks = []
    for _ in range(num_blocks):
        steps = []
        for _ in range(num_steps):
            a_sal, b_sal = np.random.randn(2)
            if not init_random:
                b_sal = float(np_inv_softplus(abs(b_sal + 1.0)))
            steps.append(("sinh_arcsinh", {"init_a": a_sal, "init_b": b_sal,
                                           "add_init_f0": False,
                                           "set_restrictions": True}))
        blocks += _step_block(steps, addf0, init_random)
    return blocks


def StepArcSL(num_blocks, num_steps, **kwargs):
    set_res, addf0, init_random, _ = _common(kwargs)
    blocks = []
    for _ in range(num_blocks):
        steps = []
        for _ in range(num_steps):
            e1, e2, e3, e4 = np.random.randn(4)
            if not init_random:
                e2 = float(np_inv_softplus(abs((e2 + 1.0) / num_steps)))
                e4 = float(np_inv_softplus(abs((e4 + 1.0) / num_steps)))
            steps.append(("arcsinh", {"init_a": e1, "init_b": e2, "init_c": e3,
                                      "init_d": e4, "add_init_f0": False,
                                      "set_restrictions": True}))
        blocks += _step_block(steps, addf0, init_random)
    return blocks


def StepBoxCoxL(num_blocks, num_steps, **kwargs):
    set_res, addf0, init_random, constraint = _common(kwargs)
    blocks = []
    for _ in range(num_blocks):
        steps = []
        for _ in range(num_steps):
            lam = float(np.random.randn(1)[0])
            if not init_random:
                lam += 5.0
            steps.append(("boxcox", {"init_lam": lam, "add_init_f0": addf0,
                                     "constraint": constraint}))
        blocks += _step_block(steps, addf0, init_random)
    return blocks


def StepInverseBoxCoxL(num_blocks, num_steps, **kwargs):
    set_res, addf0, init_random, constraint = _common(kwargs)
    blocks = []
    for _ in range(num_blocks):
        steps = []
        for _ in range(num_steps):
            lam = float(np.random.randn(1)[0])
            if not init_random:
                lam += 5.0
            steps.append(("inverseboxcox", {"init_lam": lam, "add_init_f0": addf0,
                                            "constraint": constraint}))
        blocks += _step_block(steps, addf0, init_random)
    return blocks


def StepAllL(num_blocks, **kwargs):
    """One of each: invBC, BC, arcsinh, SAL, tanh in a step combination.
    Only the first block is built: the JAX package (like the paper's code)
    returns inside the block loop, and seeded runs depend on its draws."""
    set_res, addf0, init_random, constraint = _common(kwargs)
    num_steps = 5
    blocks = []
    for _ in range(num_blocks):
        steps = []
        lam = float(np.random.randn(1)[0]) + (0.0 if init_random else 5.0)
        steps.append(("inverseboxcox", {"init_lam": lam, "add_init_f0": addf0,
                                        "constraint": constraint}))
        lam = float(np.random.randn(1)[0]) + (0.0 if init_random else 5.0)
        steps.append(("boxcox", {"init_lam": lam, "add_init_f0": addf0,
                                 "constraint": constraint}))
        e1, e2, e3, e4 = np.random.randn(4)
        if not init_random:
            e2 = float(np_inv_softplus(abs((e2 + 1.0) / num_steps)))
            e4 = float(np_inv_softplus(abs((e4 + 1.0) / num_steps)))
        steps.append(("arcsinh", {"init_a": e1, "init_b": e2, "init_c": e3,
                                  "init_d": e4, "add_init_f0": False,
                                  "set_restrictions": True}))
        a_sal, b_sal = np.random.randn(2)
        if not init_random:
            b_sal = float(np_inv_softplus(abs(b_sal + 1.0)))
        steps.append(("sinh_arcsinh", {"init_a": a_sal, "init_b": b_sal,
                                       "add_init_f0": False,
                                       "set_restrictions": True}))
        e1, e2, e3, e4 = np.random.randn(4)
        if not init_random:
            e2 = float(np_inv_softplus(abs((e2 + 1.0) / num_steps)))
            e4 = float(np_inv_softplus(abs((e4 + 1.0) / num_steps)))
        steps.append(("tanh", {"init_a": e1, "init_b": e2, "init_c": e3,
                               "init_d": e4, "add_init_f0": False,
                               "set_restrictions": True}))
        blocks += _step_block(steps, addf0, init_random)
        return blocks
    return blocks


def build_chain(flow_combination, num_blocks, **kwargs):
    """Chains of combined flows; Box-Cox members default to the bounded
    'sigmoid_ref' constraint."""
    constraint = kwargs.get("constraint", "sigmoid_ref")
    table = {
        "SAL_BCL": lambda: SAL(1) + BoxCoxL(1, constraint=constraint),
        "SAL_InvBCL": lambda: SAL(1) + InverseBoxCoxL(1, constraint=constraint),
        "SAL_AL": lambda: SAL(1) + ArcSL(1),
        "BCL_AL": lambda: BoxCoxL(1, constraint=constraint) + ArcSL(1),
        "InvBCL_AL": lambda: InverseBoxCoxL(1, constraint=constraint) + ArcSL(1),
    }
    if flow_combination not in table:
        raise ValueError(flow_combination)
    out = []
    for _ in range(num_blocks):
        out.extend(table[flow_combination]())
    return out


def identity():
    return [("identity", {})]


def random_flow(name: str, output_range=None):
    """Randomly-initialised single flows for gaussianization experiments.

    Accepts a name or a (nested) list of names and returns a flat spec
    list.  `output_range=(y_min, y_max)` is required for 'step_flow' (a
    tanh ladder over the data range).
    """
    if isinstance(name, (list, tuple)):
        out = []
        for n in name:
            out.extend(random_flow(n, output_range=output_range))
        return out
    if name == "affine":
        a, b = np.random.randn(2)
        return [("affine", {"init_a": a, "init_b": b, "set_restrictions": True})]
    if name == "arcsinh":
        a, b, c, d = np.random.randn(4)
        return [("arcsinh", {"init_a": a, "init_b": b, "init_c": c, "init_d": d,
                             "add_init_f0": False, "set_restrictions": True})]
    if name == "inverse_arcsinh":
        a, b, c, d = np.random.randn(4)
        return [("inverse_arcsinh", {"init_a": a, "init_b": b, "init_c": c,
                                     "init_d": d, "add_init_f0": False,
                                     "set_restrictions": True})]
    if name in ("sinh_arcsinhflow", "sinh_arcsinh"):
        a, b = np.random.randn(2)
        return [("sinh_arcsinh", {"init_a": a, "init_b": b, "add_init_f0": False,
                                  "set_restrictions": True})]
    if name in ("inverse_sinh_arcsinhflow", "inverse_sinh_arcsinh"):
        a, b = np.random.randn(2)
        return [("inverse_sinh_arcsinh", {"init_a": a, "init_b": b,
                                          "add_init_f0": False,
                                          "set_restrictions": True})]
    if name == "exp":
        return [("exp", {})]
    if name == "softplus":
        return [("softplus", {})]
    if name == "inverse_boxcox":
        # translation + constrained inverse Box-Cox
        return [("translation", {"init_b": 0.0}),
                ("inverseboxcox", {"init_lam": 0.01, "add_init_f0": False,
                                   "constraint": "sigmoid2"})]
    if name == "tukey_right":
        g, h = np.random.randn(2)
        return [("tukey_right", {"init_g": g, "init_h": h, "add_init_f0": False})]
    if name == "step_flow":
        if output_range is None:
            raise ValueError("random_flow('step_flow') needs output_range="
                             "(y_min, y_max)")
        from .initializers import step_flow_ladder
        return step_flow_ladder(K=5, output_range=tuple(output_range),
                                smoothness_scale=0.01, remove_tails=False)
    raise ValueError(f"unknown random flow {name!r}")
