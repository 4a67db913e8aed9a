"""Shared tiny geometry for the oatx_torch tests: the same numpy-seeded inputs
and oatx params go through oatx (JAX, CPU) and the port (PyTorch, CPU)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from oatx.models import distilbert as jdb
from oatx.models import towers as jtowers
from oatx.models import vit_spacetime as jvst
from oatx.train import step as jstep
from oatx_torch.models import distilbert as pdb
from oatx_torch.models import towers as ptowers
from oatx_torch.models import vit_spacetime as pvst
from oatx_torch.models.convert import state_dict_from_oatx
from oatx_torch.train import optim as poptim
from oatx_torch.train import step as pstep

# depth 2, D = 64, 4 heads, img 32, patch 16 (4 patches per frame), 2 frames;
# DistilBERT 2 layers, dim 64, vocab 100
VIDEO = dict(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
             num_frames=2, time_init="random")
TEXT = dict(vocab_size=100, max_position_embeddings=32, dim=64, hidden_dim=128,
            n_layers=2, n_heads=4)
PROJ = 32


def oatx_cfg(**video_kw) -> jtowers.TowerConfig:
    return jtowers.TowerConfig(
        video=jvst.SpaceTimeViTConfig(**{**VIDEO, **video_kw}),
        text=jdb.DistilBertConfig(**TEXT), projection_dim=PROJ)


def port_cfg() -> ptowers.TowerConfig:
    return ptowers.TowerConfig(
        video=pvst.SpaceTimeViTConfig(**VIDEO),
        text=pdb.DistilBertConfig(**TEXT), projection_dim=PROJ)


def oatx_params(cfg: jtowers.TowerConfig, seed: int = 1):
    """oatx params with every bias and LN affine made non-trivial, so the
    bridge and the casts are exercised (init leaves them 0 / 1)."""
    params = jtowers.init(jax.random.PRNGKey(seed), cfg)
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32)
              for a in leaves]
    return jax.tree_util.tree_unflatten(tree, [jax.numpy.asarray(a) for a in leaves])


def to_numpy(params):
    return jax.tree_util.tree_map(np.asarray, params)


def port_model(params, cfg: ptowers.TowerConfig = None) -> ptowers.DualTower:
    cfg = cfg or port_cfg()
    m = ptowers.DualTower(cfg, device="cpu")
    m.load_state_dict(state_dict_from_oatx(to_numpy(params), cfg), strict=True)
    return m.eval()


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- train step
# depth 2, D = 32, 2 heads, 2 frames at 32²; DistilBERT 2 layers, dim 32;
# 16-d projections; batch 4. oatx runs its fused residual stream CLS first
# (split_cls_stream=False), which is the port's layout.
TRAIN_VIDEO = dict(img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2,
                   num_frames=2, time_init="random")
TRAIN_TEXT = dict(vocab_size=100, max_position_embeddings=32, dim=32, hidden_dim=64,
                  n_layers=2, n_heads=2)
TRAIN_LR = 2e-4


def train_cfgs(fused_qkv=False, bf16=False):
    """(oatx TowerConfig, port TowerConfig) of the tiny train geometry."""
    j = jtowers.TowerConfig(
        video=jvst.SpaceTimeViTConfig(**TRAIN_VIDEO, fused_qkv=fused_qkv,
                                      split_cls_stream=False, cls_position="first"),
        text=jdb.DistilBertConfig(**TRAIN_TEXT), projection_dim=16,
        compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    p = ptowers.TowerConfig(
        video=pvst.SpaceTimeViTConfig(**TRAIN_VIDEO, fused_qkv=fused_qkv),
        text=pdb.DistilBertConfig(**TRAIN_TEXT), projection_dim=16,
        compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    return j, p


def train_batch(seed=0):
    """A numpy batch of 4 clips and captions, two of them padded."""
    rng = np.random.default_rng(seed)
    mask = np.ones((4, 6), np.int32)
    mask[1, 4:] = 0
    mask[3, 3:] = 0
    return {"video": rng.standard_normal((4, 2, 32, 32, 3)).astype(np.float32),
            "input_ids": rng.integers(0, 100, (4, 6)).astype(np.int32),
            "attention_mask": mask}


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def train_port_state(params, pcfg, **opt_kw):
    """The port's TrainState on the CPU from oatx params, AdamW at TRAIN_LR."""
    return pstep.init_state(pcfg, poptim.make_optimizer(lr=TRAIN_LR, **opt_kw),
                            device="cpu",
                            state_dict=state_dict_from_oatx(to_numpy(params), pcfg))


def oatx_loss_grads(params, jcfg, batch):
    """(loss, grads) of oatx `loss_fn` (baseline, NormSoftmax 0.05)."""
    f = jax.jit(jax.value_and_grad(jstep.loss_fn, has_aux=True), static_argnums=(1, 2))
    (loss, _), grads = f(params, jcfg, jstep.LossConfig(), jax_batch(batch))
    return float(loss), grads
