"""The port's one-card command lines, counterparts of the root ``train.py``
and ``eval.py`` of the JAX package:

    python -m lrce_tpu_torch.cli.train --dataset tgif-frameqa --dataset-dir DIR
    python -m lrce_tpu_torch.cli.eval --dataset tgif-frameqa --dataset-dir DIR \\
        --model-path RUN/weights/best.pt
"""
