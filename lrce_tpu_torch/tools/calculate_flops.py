"""Alias of the fusion-cost benchmark under the reference's name (the
counterpart of the root ``calculate_flops.py``); the implementation is
``lrce_tpu_torch/tools/flops.py``.

    python -m lrce_tpu_torch.tools.calculate_flops [--batch 1] [--steps 4]
"""

from lrce_tpu_torch.tools.flops import main

if __name__ == "__main__":
    main()
