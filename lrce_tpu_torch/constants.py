"""Constants of the port, copied from the JAX package's
(lrce_tpu/constants.py) so that the port imports nothing of it."""

VIDEO_EXT = (".avi", ".gif", ".mp4")
CLS_TOKEN = "[CLS]"
SEP_TOKEN = "[SEP]"
SANITY_CHECK_SIZE = 500

# Label value that is excluded from the cross-entropy loss and can never be
# predicted (used for out-of-vocabulary answers).
IGNORE_INDEX = -100

# ImageNet normalization applied to video frames before the Swin backbone.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
