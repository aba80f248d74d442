"""Constants of the port. The ImageNet statistics are the JAX package's
(lrce_tpu/constants.py), copied so that the port imports nothing of it."""

# ImageNet normalization applied to video frames before the Swin backbone.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
