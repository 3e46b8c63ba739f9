"""End-to-end examples of the port (counterparts of the JAX package's
``examples/``): ``python -m icpslam_tpu_torch.examples.<name>``."""
