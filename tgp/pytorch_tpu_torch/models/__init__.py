from .means import mean_init, mean_apply, projection_matrix
from .tgp import TGPSpec, TGP, init_tgp_params, svgp_spec
from .deep import DeepTGPSpec, layer_spec, init_deep_params
