"""Constants of the port (counterpart of ``vince_tpu/constants.py``): the
run's timestamp, which the checkpoint and tensorboard paths embed, and the
ImageNet normalisation, on the uint8 scale and the unit scale."""

import datetime

import numpy as np

IMAGENET_MEAN_255 = np.array([0.485, 0.456, 0.406], dtype=np.float32) * 255.0
IMAGENET_STD_255 = np.array([0.229, 0.224, 0.225], dtype=np.float32) * 255.0
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

TIME_STR = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
