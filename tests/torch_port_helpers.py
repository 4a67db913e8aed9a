"""Shared tiny geometry for the oatx_torch tests: the same numpy-seeded inputs
and oatx params go through oatx (JAX, CPU) and the port (PyTorch, CPU)."""

from __future__ import annotations

import dataclasses
import os
import pathlib

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


# ------------------------------------------------------------ trainer data
from torch_port_clips import OBJECT_SLOTS, OBJECT_VLEN, MemoryClips, write_object_npz  # noqa: E402,F401


class OatxMemoryClips:
    """The same clips and object files with oatx's object extras: oatx's
    `TextVideoDataset._add_object_extras` (and its frame sampler) on a bare
    instance, the object frame served by `decode_indices`, which the caller
    patches with `patch_oatx_decode`."""

    dataset_name = "MemoryClips"

    def __init__(self, clips: MemoryClips, object_options):
        from oatx.data.datasets.base import TextVideoDataset

        self.clips = clips
        ds = object.__new__(TextVideoDataset)
        ds.opts = object_options
        ds.object_vocab = clips.object_vocab
        ds.canon = clips.videos.shape[2]
        ds._get_object_path = clips._get_object_path
        ds._get_video_path = lambda rec: (f"memory:{rec}", f"memory:{rec}")
        self.ds = ds

    def __len__(self) -> int:
        return len(self.clips)

    @property
    def opts(self):
        """The object options (oatx's Trainer reads `dataset.opts.features`)."""
        return self.ds.opts

    def get_sample(self, i: int, rng: np.random.Generator):
        from oatx.data.sampling import sample_frames as jsample_frames

        sample = self.clips.base_sample(i, rng)
        idxs = jsample_frames(self.clips.videos.shape[1], OBJECT_VLEN, rng=rng)
        self.ds._add_object_extras(sample, i, idxs, OBJECT_VLEN, rng)
        return sample


def patch_oatx_decode(monkeypatch, clips: MemoryClips) -> None:
    """oatx's object-frame decode (`video_reader.decode_indices`) serves
    `clips`' object frames for the paths OatxMemoryClips names."""
    from oatx.data.datasets import base as jbase

    def decode(path, indices, short_side=0):
        return clips.object_frames[int(path.split(":")[1])]

    monkeypatch.setattr(jbase.vr, "decode_indices", decode)


class OatxBackedHandle:
    """The port's `VideoHandle` interface served by oatx's FFmpeg reader:
    patched in (`patch_port_decode`), the port's datasets decode exactly
    the frames oatx's do, so their samples compare exactly. oatx's
    DecodeError becomes the port's, which the port's lax loading catches."""

    def __init__(self, path: str):
        from oatx.data import video_reader as jvr
        from oatx_torch.data import video_reader as pvr

        self._err = pvr.DecodeError
        try:
            self._h = jvr.VideoHandle(path)
        except jvr.DecodeError as e:
            raise pvr.DecodeError(str(e)) from e

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._h.close()

    def info(self):
        return self._h.info()

    def out_size(self, short_side: int = 0):
        return self._h.out_size(short_side)

    def decode(self, indices, short_side: int = 0, device=None):
        from oatx.data import video_reader as jvr

        try:
            return self._h.decode(indices, short_side)
        except jvr.DecodeError as e:
            raise self._err(str(e)) from e


def pil_decode_jpeg_bytes(data: bytes) -> np.ndarray:
    """What oatx's tar path decodes a member with (PIL, native size)."""
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.uint8)


def patch_port_decode(monkeypatch) -> None:
    """The port's reader serves oatx's decoded frames (files through oatx's
    FFmpeg reader, tar members through PIL, as oatx's tar path does)."""
    from oatx_torch.data import video_reader as pvr

    monkeypatch.setattr(pvr, "VideoHandle", OatxBackedHandle)
    monkeypatch.setattr(pvr, "decode_jpeg_bytes", pil_decode_jpeg_bytes)


# ------------------------------------------------------- data-parallel ranks
DP_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dp_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch_dp(mode: str, world: int, payload, tmp, timeout: float = 150.0):
    """Run tests/torch_dp_worker.py MODE on `world` gloo ranks (a file://
    rendezvous under `tmp`, one CPU thread each) with `payload` → each
    rank's results. A rank that fails or outlives `timeout` seconds fails
    the test; every rank is stopped on the way out."""
    import subprocess
    import sys

    tmp = pathlib.Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    src, dst = tmp / f"{mode}.in.pt", tmp / f"{mode}.out"
    torch.save(payload, src)
    env = {k: v for k, v in os.environ.items() if not k.startswith("OATX_")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    store = tmp / f"{mode}.store"
    procs = [subprocess.Popen([sys.executable, DP_WORKER, mode, str(r), str(world),
                               store.as_uri(), str(src), str(dst)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}/{world} exited {p.returncode}:\n{out[-4000:]}"
    return [torch.load(f"{dst}.rank{r}", weights_only=False) for r in range(world)]
