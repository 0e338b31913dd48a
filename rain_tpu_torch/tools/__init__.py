"""The part-mask and VLM helpers: the port of rain_tpu/tools."""
