"""Matmul FLOPs of the flagship model's forward pass, for a train step's MFU.

The port's own copy of bench.py:39-71 `flops_forward_per_clip` (the port
imports nothing of oatx or bench.py). A train step is taken as 3× the
forward (backward = 2× forward); the optimizer is not counted.
"""

from __future__ import annotations


def flops_forward_per_clip(vcfg, tcfg, seq_len: int) -> float:
    """True matmul FLOPs (2·m·n·k per product) of one clip's forward pass
    through both towers.

    Video tower: T = 1 + F·N tokens; each block has TWO attention sublayers
    (time + space, each qkv 6TD² + proj 2TD²) and an MLP (16TD² at
    mlp_ratio 4). Attention einsums: space = patches over N+1 keys per frame
    + CLS over T; time = patches over F+1 keys + CLS over T.
    """
    D = vcfg.embed_dim
    F = vcfg.num_frames
    N = vcfg.patches_per_frame
    T = 1 + F * N
    mlp_hidden = int(D * vcfg.mlp_ratio)

    patch_embed = 2 * F * N * (vcfg.patch_size ** 2 * vcfg.in_chans) * D
    per_block = (
        2 * (6 * T * D * D + 2 * T * D * D)      # time + space qkv & out-proj
        + 2 * (2 * T * D * mlp_hidden)           # mlp fc1 + fc2
        + 4 * F * N * (N + 1) * D                # space attn QK^T + AV (patches)
        + 4 * N * F * (F + 1) * D                # time attn QK^T + AV (patches)
        + 2 * 4 * T * D                          # cls row in both sublayers
    )
    video = patch_embed + vcfg.depth * per_block + 2 * D * 256  # + projection

    Dt = tcfg.dim
    L = seq_len
    per_text_block = (
        6 * L * Dt * Dt + 2 * L * Dt * Dt        # qkv + out-proj
        + 2 * (2 * L * Dt * tcfg.hidden_dim)     # mlp
        + 4 * L * L * Dt                         # attention einsums
    )
    text = tcfg.n_layers * per_text_block + 2 * Dt * 256
    return float(video + text)
