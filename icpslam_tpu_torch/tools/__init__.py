"""Mission-scale tools of the port (counterparts of the JAX package's
``tools/``): each runs as ``python -m icpslam_tpu_torch.tools.<name>``, on
the CUDA card by default and on the CPU only with ``--device cpu``, and
writes the artifact its JAX original writes, with the card's name and
power limit beside it. Default artifacts go to
``icpslam_tpu_torch/artifacts/``."""
