"""Multi-device inference over ``torch.distributed`` process groups: the
``mc`` axis (MC samples split over ranks) of epistemic inference, the
``dp`` axis (the image batch split over ranks) of batched inference, and
the ``sp`` axis (image rows split over ranks, halo exchange), alone or
composed with ``mc``."""

from .batch import make_dp_batched_pipeline  # noqa: F401
from .epistemic import (  # noqa: F401
    make_mc_sharded_forward,
    make_mc_sharded_fused_pipeline,
    sharded_moments_rows,
)
from .mesh import (  # noqa: F401
    Group,
    initialize_distributed,
    local_rank,
    local_rows,
    make_groups,
    maybe_initialize_from_config,
    world_group,
)
from .spatial import Band, spatial_forward_raws, spatial_mc_raws  # noqa: F401
