"""Shared tiny geometry for the oatx_torch tests: the same numpy-seeded inputs
and oatx params go through oatx (JAX, CPU) and the port (PyTorch, CPU)."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from oatx.models import distilbert as jdb
from oatx.models import towers as jtowers
from oatx.models import vit_spacetime as jvst
from oatx_torch.models import distilbert as pdb
from oatx_torch.models import towers as ptowers
from oatx_torch.models import vit_spacetime as pvst
from oatx_torch.models.convert import state_dict_from_oatx

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
