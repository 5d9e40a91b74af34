"""Tensor ops of the port (counterparts of codec_tpu/ops/)."""
