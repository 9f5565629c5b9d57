from .loop import Trainer, merge_params, partition_params  # noqa: F401
from .checkpoints import CheckpointStore  # noqa: F401
