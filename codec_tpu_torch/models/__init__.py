"""Codec models of the port (counterparts of codec_tpu/models/)."""
