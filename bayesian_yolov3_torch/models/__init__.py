from .darknet import (  # noqa: F401
    DARKNET53_CONV_SPECS,
    SKIP8_IDX,
    SKIP16_IDX,
    init_darknet53,
    darknet53,
    load_darknet53_weights,
)
from .yolov3 import (  # noqa: F401
    YoloV3,
    init_yolov3,
    forward,
    forward_cf,
    mc_forward,
    mc_forward_cf,
)
