"""The VLM probes: the port of rain_tpu/tools/vlm."""
