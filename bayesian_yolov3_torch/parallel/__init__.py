"""Multi-device inference over ``torch.distributed`` process groups: the
``mc`` axis (MC samples split over ranks) of epistemic inference."""

from .epistemic import make_mc_sharded_forward, make_mc_sharded_fused_pipeline  # noqa: F401
from .mesh import (  # noqa: F401
    Group,
    initialize_distributed,
    local_rank,
    local_rows,
    make_group,
    maybe_initialize_from_config,
)
