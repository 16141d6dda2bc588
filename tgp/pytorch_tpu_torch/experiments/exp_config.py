"""Validated per-dataset flow hyperparameters: the port's own copy of the
experiment tables of the repo's `experiments/exp_config.py` (the paper's
validation-search tables), with the same numbers.
"""

HYPERPARAMS = {
    # (model, dataset) -> flow config
    ("ID_TGP", "boston"): dict(
        flow_arch="SAL", num_blocks=1, num_steps=None, flow_hidden_act="tanh",
        flow_num_hidden_layers=1, flow_DR=0.5, flow_BN=0, flow_hidden_dim=25,
        flow_inference="MC_dropout"),
    ("ID_TGP", "power"): dict(
        flow_arch="SAL", num_blocks=3, num_steps=None, flow_hidden_act="relu",
        flow_num_hidden_layers=2, flow_DR=0.25, flow_BN=0, flow_hidden_dim=50,
        flow_inference="MC_dropout"),
    ("TGP", "boston"): dict(
        flow_arch="StepTanhL", num_blocks=10, num_steps=2, flow_hidden_act=None,
        flow_num_hidden_layers=None, flow_DR=None, flow_BN=None,
        flow_hidden_dim=None, flow_inference=None),
    ("TGP", "power"): dict(
        flow_arch="SAL", num_blocks=2, num_steps=None, flow_hidden_act=None,
        flow_num_hidden_layers=None, flow_DR=None, flow_BN=None,
        flow_hidden_dim=None, flow_inference=None),
}

SVGP_DEFAULT = dict(flow_arch=None, num_blocks=None, num_steps=None,
                    flow_hidden_act=None, flow_num_hidden_layers=None,
                    flow_DR=None, flow_BN=None, flow_hidden_dim=None,
                    flow_inference=None)


def return_hyperparams(model: str, dataset: str) -> dict:
    """Validated flow config for (model, dataset).

    The explicit HYPERPARAMS entries carry the paper code's main.py
    defaults; every other dataset falls back to the paper's sweep tables
    below, so the CLI dispatches all nine regression corpora.
    """
    if model == "SVGP":
        return dict(SVGP_DEFAULT)
    key = (model, dataset)
    if key in HYPERPARAMS:
        return dict(HYPERPARAMS[key])
    if model == "TGP" and dataset in TGP_REGRESSION_SWEEP:
        arch, nb, ns = TGP_REGRESSION_SWEEP[dataset]
        hp = dict(SVGP_DEFAULT)
        hp.update(flow_arch=arch, num_blocks=nb, num_steps=ns)
        return hp
    if model == "ID_TGP" and dataset in ID_TGP_REGRESSION_SWEEP:
        nb, act, nh, dr, bn, width = ID_TGP_REGRESSION_SWEEP[dataset]
        return dict(flow_arch="SAL", num_blocks=nb, num_steps=None,
                    flow_hidden_act=act, flow_num_hidden_layers=nh,
                    flow_DR=dr, flow_BN=bn, flow_hidden_dim=width,
                    flow_inference="MC_dropout")
    raise KeyError(f"no validated hyperparameters for {key}; add them to "
                   f"tgp/pytorch_tpu_torch/experiments/exp_config.py")


# ---------------------------------------------------------------------------
# Full paper sweep tables (the paper code's launch_test_uci_*.sh scripts)
# ---------------------------------------------------------------------------

#: TGP (non-input-dependent) flow arch per regression dataset
TGP_REGRESSION_SWEEP = {
    "boston":     ("StepTanhL", 10, 2),
    "concrete":   ("StepInverseBoxCoxL", 5, 2),
    "energy":     ("StepTanhL", 15, 4),
    "kin8nm":     ("InverseBoxCoxL", 1, None),
    "naval":      ("SAL_InvBCL", 1, None),
    "power":      ("SAL", 2, None),
    "protein":    ("StepTanhL", 10, 2),
    "wine_red":   ("SAL", 3, None),
    "wine_white": ("SAL_BCL", 10, None),
    # large
    "year":       ("SAL", 5, None),
    "airline":    ("StepTanhL", 5, 6),
}

#: ID_TGP hypernet configs: (blocks, act, n_hidden, dropout, bn, width)
ID_TGP_REGRESSION_SWEEP = {
    "boston":     (1, "tanh", 1, 0.5, 0, 25),
    "concrete":   (1, "relu", 1, 0.25, 0, 50),
    "energy":     (3, "relu", 2, 0.5, 0, 50),
    "kin8nm":     (3, "relu", 2, 0.25, 0, 50),
    "naval":      (1, "relu", 1, 0.5, 0, 25),
    "power":      (3, "relu", 2, 0.25, 0, 50),
    "protein":    (1, "relu", 1, 0.25, 0, 25),
    "wine_red":   (3, "tanh", 1, 0.25, 0, 25),
    "wine_white": (3, "tanh", 2, 0.25, 0, 50),
    "year":       (1, "tanh", 2, 0.25, 0, 50),
    "airline":    (1, "tanh", 2, 0.25, 0, 50),
}

#: classification; hold_K_params=2000 epochs following Hensman 2015b
TGP_CLASSIFICATION_SWEEP = {
    "movement": ("ArcSL", 2, None),
    "heart":    ("SAL_InvBCL", 1, None),
    "banknote": ("BCL_AL", 5, None),
    "avila":    ("SAL_AL", 1, None),
    "activity": ("BCL_AL", 1, None),
    # synthetic stand-ins: the heart-style binary and activity-style
    # 3-class configurations
    "synthetic_binary":     ("SAL_InvBCL", 1, None),
    "synthetic_multiclass": ("BCL_AL", 1, None),
}

ID_TGP_CLASSIFICATION_SWEEP = {
    "movement": (1, "relu", 2, 0.25, 0, 25),
    "heart":    (1, "tanh", 1, 0.5, 0, 25),
    "banknote": (1, "tanh", 2, 0.25, 0, 50),
    "avila":    (1, "tanh", 1, 0.75, 0, 25),
    "activity": (1, "tanh", 1, 0.75, 0, 25),
    "synthetic_binary":     (1, "tanh", 1, 0.5, 0, 25),
    "synthetic_multiclass": (1, "tanh", 1, 0.75, 0, 25),
}

HOLD_K_PARAMS_EPOCHS = 2000
SWEEP_SEEDS = list(range(1, 11))
SWEEP_NUM_INDUCING = [5, 10, 20, 50, 100]

#: number of validation points per dataset
NUM_VALID_POINTS = {
    "boston": 100, "energy": 150, "concrete": 200, "kin8nm": 1000,
    "naval": 1500, "power": 1000, "protein": 5000, "wine_white": 600,
    "wine_red": 300, "airline": 500000, "year": 100000, "avila": 2000,
    "heart": 50, "movement": 1000, "activity": 5000, "banknote": 200,
}
