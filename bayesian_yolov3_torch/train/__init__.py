from .loop import merge_params, partition_params  # noqa: F401
from .checkpoints import CheckpointStore  # noqa: F401
