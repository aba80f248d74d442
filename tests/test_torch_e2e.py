"""The port's end-to-end forward (lrce_tpu_torch/models/e2e.py) against
lrce_tpu's e2e_forward on the same weights and inputs, f32 on the CPU, with
the tiny encoders of lrce_tpu.models.e2e.config_from_args (Swin embed 8,
BERT 36 wide) at the flagship's 224 x 224 geometry, 3 clips of 5 uint8
frames, for all three heads.

Tolerance 5e-4 (rtol and atol): the composed forward chains Swin (8
blocks), BERT, and 12 fusion layers over 3 clips; the JAX package's own
composed drift at this geometry is at most 1.4e-4 (README).

Also: importing the port (its training package included) and running its
slice never imports JAX.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from lrce_tpu.models import bert as B
from lrce_tpu.models import e2e as E
from lrce_tpu.models import swin3d as S
from lrce_tpu_torch.models import bert as PB
from lrce_tpu_torch.models import e2e as PE
from lrce_tpu_torch.models import swin3d as PS
from lrce_tpu_torch.utils.convert import state_dict_from_jax

TOL = dict(rtol=5e-4, atol=5e-4)
REPO = Path(__file__).resolve().parent.parent


def tiny_configs(task: str):
    kw = dict(feature_dim=36, num_classes=1 if task == "mc" else 11,
              video_feature_res=(7, 7), video_feature_dim=64,
              frame_sample_size=5, temporal_scale=(3,), text_seq_len=8,
              task_type=task)
    jcfg = E.E2EConfig(
        **kw, bert=B.BertConfig(hidden_size=36, num_layers=2, num_heads=2,
                                intermediate_size=72),
        swin=S.SwinConfig(embed_dim=8, depths=(2, 2, 2, 2),
                          num_heads=(2, 2, 2, 2), drop_path_rate=0.0))
    pcfg = PE.E2EConfig(
        **kw, bert=PB.BertConfig(hidden_size=36, num_layers=2, num_heads=2,
                                 intermediate_size=72),
        swin=PS.SwinConfig(embed_dim=8, depths=(2, 2, 2, 2),
                           num_heads=(2, 2, 2, 2)))
    return jcfg, pcfg


def tiny_inputs(task: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    b, m = 2, 3
    clips = rng.integers(0, 256, (b, 3, 5, 224, 224, 3), dtype=np.uint8)
    tshape = (b, m, 8) if task == "mc" else (b, 8)
    ids = rng.integers(0, 1000, tshape)
    mask = np.ones(tshape, np.int64)
    mask[..., 6:] = 0
    types = np.zeros(tshape, np.int64)
    return clips, ids, mask, types


@pytest.mark.parametrize("task", ["oe", "mc", "count"])
def test_e2e_forward_matches_jax(task):
    jcfg, pcfg = tiny_configs(task)
    params = jax.tree.map(np.asarray, E.e2e_init(jax.random.PRNGKey(0), jcfg))
    model = PE.LRCEModel(pcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    clips, ids, mask, types = tiny_inputs(task)
    want = np.asarray(E.e2e_forward(params, clips, ids.astype(np.int32),
                                    mask.astype(np.int32),
                                    types.astype(np.int32), jcfg))
    args = [torch.from_numpy(a) for a in (clips, ids, mask, types)]
    got = PE.e2e_forward(model, *args).numpy()
    assert got.shape == want.shape == {"oe": (2, 11), "mc": (2, 3),
                                       "count": (2,)}[task]
    np.testing.assert_allclose(got, want, **TOL)
    if task == "oe":   # the plain route gives the same answer
        model.video_extractor.swin.use_kernels = False
        np.testing.assert_allclose(PE.e2e_forward(model, *args).numpy(), want,
                                   **TOL)


def test_e2e_forward_rejects_bad_shapes():
    _, pcfg = tiny_configs("oe")
    model = PE.LRCEModel(pcfg, device="cpu")
    clips, ids, mask, types = (torch.from_numpy(a) for a in tiny_inputs("oe"))
    with pytest.raises(ValueError, match="clips"):
        PE.e2e_forward(model, clips[:, :2], ids, mask, types)
    with pytest.raises(ValueError, match="ndim"):
        PE.e2e_forward(model, clips, ids[:, None], mask, types)


def test_model_defaults_to_the_card_and_raises_without_one():
    """``LRCEModel(cfg)`` is built on the card; with no CUDA and no device
    given it raises and never carries on on the CPU. The CPU is asked for
    by name."""
    _, pcfg = tiny_configs("oe")
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PE.LRCEModel(pcfg)
    model = PE.LRCEModel(pcfg, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    # the Swin tower's LN2 + MLP route is chosen by shape, by no argument
    assert not hasattr(model.video_extractor.swin, "ln_mlp")
    with pytest.raises(TypeError, match="ln_mlp"):
        PE.LRCEModel(pcfg, device="cpu", ln_mlp=True)


def test_port_never_imports_jax():
    code = textwrap.dedent("""
        import sys
        import torch
        import lrce_tpu_torch
        from lrce_tpu_torch import constants
        from lrce_tpu_torch import config, native, pretrained
        from lrce_tpu_torch.cli import eval as cli_eval
        from lrce_tpu_torch.cli import train as cli_train
        from lrce_tpu_torch.data import datasets, loader, prefetch, sampling
        from lrce_tpu_torch.data import tokenizer, tsv, video_decode
        from lrce_tpu_torch.ops import cuda_lib, mlp, nn, swin_block, window_attn
        from lrce_tpu_torch.models import bert, e2e, embedding, fusion, swin3d
        from lrce_tpu_torch.train import agent, losses, optimizer, schedule
        from lrce_tpu_torch.utils import checkpoint, convert, device, logging
        from lrce_tpu_torch.utils import pytree, vocab
        # the data layer and the CLIs need no image, table or HF library
        # (the native decoders and read_tsv take their place)
        loaded = [m for m in ("PIL", "cv2", "pandas", "transformers")
                  if m in sys.modules]
        assert not loaded, loaded
        cfg = e2e.E2EConfig(
            feature_dim=36, num_classes=5, video_feature_dim=64,
            text_seq_len=8,
            bert=bert.BertConfig(hidden_size=36, num_layers=1, num_heads=2,
                                 intermediate_size=72),
            swin=swin3d.SwinConfig(embed_dim=8, depths=(2, 2, 2, 2),
                                   num_heads=(2, 2, 2, 2)))
        model = e2e.LRCEModel(cfg, device="cpu")
        clips = torch.randint(0, 256, (1, 3, 5, 224, 224, 3), dtype=torch.uint8)
        ids = torch.randint(0, 1000, (1, 8))
        out = e2e.e2e_forward(model, clips, ids, torch.ones_like(ids),
                              torch.zeros_like(ids))
        assert out.shape == (1, 5)
        jax_mods = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
                    or m == "lrce_tpu" or m.startswith("lrce_tpu.")]
        assert not jax_mods, jax_mods
        print("no-jax-ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "no-jax-ok" in proc.stdout
