from .ecp import bbox_to_ecp_format  # noqa: F401
from .runner import InferenceRunner  # noqa: F401
