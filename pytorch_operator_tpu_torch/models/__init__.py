"""Models ported from ``pytorch_operator_tpu/models``."""
