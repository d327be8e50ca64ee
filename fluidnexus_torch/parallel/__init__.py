from fluidnexus_torch.parallel.mesh import (  # noqa: F401
    LOGICAL_RULES, make_mesh, shard_params_logical, zero_shard_opt_state,
)
from fluidnexus_torch.parallel.cp import cp_causal_conv_time  # noqa: F401
