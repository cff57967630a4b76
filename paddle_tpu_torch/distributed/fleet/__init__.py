"""fleet (counterpart of ``paddle_tpu/distributed/fleet``): ``utils``."""
