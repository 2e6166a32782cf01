"""The benchmark of the PyTorch and CUDA port ``vince_tpu_torch`` (see
``run.py``). It imports neither JAX nor the JAX package ``vince_tpu``."""
