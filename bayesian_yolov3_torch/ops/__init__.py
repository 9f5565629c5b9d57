from .common import (  # noqa: F401
    conv2d,
    conv_block,
    detection_conv,
    detection_conv_cf,
    dropout,
    hash_keep,
    leaky_relu,
    upsample2x,
    init_conv_block,
    init_detection_conv,
    BN_EPS,
    BN_MOMENTUM,
)
