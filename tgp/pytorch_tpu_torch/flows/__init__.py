from .core import (
    FlowStep,
    FlowCtx,
    IDENTITY_SPEC,
    flow_forward,
    flow_inverse,
    flow_kld,
    flow_forward_initializer,
    init_flow_params,
    spec_from_list,
    is_identity_spec,
)
from . import generators
