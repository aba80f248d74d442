"""The port's command lines, counterparts of the root ``train.py``,
``eval.py`` and ``train_ddp.py`` of the JAX package, one rank per visible
card (``torchrun`` sets the ranks itself):

    python -m lrce_tpu_torch.cli.train --dataset tgif-frameqa --dataset-dir DIR
    python -m lrce_tpu_torch.cli.eval --dataset tgif-frameqa --dataset-dir DIR \\
        --model-path RUN/weights/best.pt
    torchrun --nproc-per-node N -m lrce_tpu_torch.cli.train_ddp \\
        --dataset tgif-frameqa --dataset-dir DIR
"""
