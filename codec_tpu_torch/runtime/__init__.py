"""Runtime objects of the port (counterpart of codec_tpu/runtime/)."""
