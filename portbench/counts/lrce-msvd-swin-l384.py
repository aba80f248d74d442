"""Operations and bytes of this configuration's work, from its shapes
(``portbench/lrce_counts.py``: Video Swin, BERT and the LRCE fusion)."""

from portbench.lrce_counts import pieces  # noqa: F401
