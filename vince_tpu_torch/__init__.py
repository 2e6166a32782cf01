"""PyTorch + CUDA port of ``vince_tpu`` for one NVIDIA H100.

The package keeps ``vince_tpu``'s module paths (``models/resnet.py`` here is
the counterpart of ``vince_tpu/models/resnet.py``), imports only ``torch`` and
numpy, and replaces each Pallas kernel on its path with a CUDA C++ kernel for
``sm_90a`` (``csrc/``), built with ``nvcc`` at first use and bound with
``ctypes``. Public functions keep the NHWC layout of images and activations.
"""
