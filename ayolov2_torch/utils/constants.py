"""Default serving/NMS parameters (the same values as the JAX package's)."""

DEFAULT_CONF_THRESHOLD = 0.001
DEFAULT_IOU_THRESHOLD = 0.65
DEFAULT_TOP_K = 512
DEFAULT_KEEP_TOP_K = 100
DEFAULT_NMS_BOX = 1000
