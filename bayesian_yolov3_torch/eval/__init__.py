"""Detection metrics over ECP-format detections (host code, numpy)."""

from .detection_metrics import (  # noqa: F401
    average_precision,
    evaluate_detections,
    log_average_miss_rate,
)
