"""The port's losses, LR schedules and AdamW against oatx (optax), on the CPU.

Losses: values and gradients in f32 at 1e-5 (the same formulas summed in
another order). Optimizer: the port's AdamW and oatx's optax chain are fed
the SAME gradients for several steps, so params, moments and the EMA must
agree to f32 rounding (rtol 1e-6, atol 1e-7; the two round the moment
updates in another order, ≤ 1 ulp a step). Schedules: float64 in the port,
f32 in optax: rtol 1e-6, and atol 1e-9 where the cosine reaches 0 (optax's
f32 cos(π) is −1 + 1e-8 of the 3e-4 base).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oatx.losses import contrastive as jc
from oatx.train import optim as joptim
from oatx_torch.losses import contrastive as pc
from oatx_torch.train import optim as poptim

torch.set_num_threads(1)
ATOL = 1e-5


def _emb(seed, n, d=16):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _value_and_grads(jfn, pfn, *arrays):
    """(jax value, jax grads) and (port value, port grads) of fn(*arrays)."""
    jv, jg = jax.value_and_grad(jfn, argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    pv = pfn(*ts)
    pg = torch.autograd.grad(pv, ts)
    return (float(jv), [np.asarray(g) for g in jg]), (float(pv.detach()), [g.numpy() for g in pg])


def _assert_same(j, p):
    np.testing.assert_allclose(p[0], j[0], atol=ATOL, rtol=0)
    for a, b in zip(p[1], j[1]):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n,m", [(8, 8), (6, 10), (10, 6)])
def test_norm_softmax_loss_matches_oatx(n, m):
    """Square and rectangular sims (the min(N, M) diagonal), through
    sim_matrix's eps-clamped normalisation."""
    t, v = _emb(n, n), _emb(100 + m, m)
    j, p = _value_and_grads(lambda a, b: jc.norm_softmax_loss(jc.sim_matrix(a, b), 0.05),
                            lambda a, b: pc.norm_softmax_loss(pc.sim_matrix(a, b), 0.05),
                            t, v)
    _assert_same(j, p)


@pytest.mark.parametrize("chunk", [4, 10, 64])
def test_norm_softmax_loss_chunked_matches_unchunked_and_oatx(chunk):
    """Key chunks that divide N, that leave a ragged last chunk, and one
    chunk larger than N: all equal the full-matrix loss."""
    t, v = _emb(1, 10), _emb(2, 10)
    full = pc.norm_softmax_loss(pc.sim_matrix(torch.from_numpy(t), torch.from_numpy(v)))
    j, p = _value_and_grads(
        lambda a, b: jc.norm_softmax_loss_chunked(a, b, 0.05, chunk=chunk),
        lambda a, b: pc.norm_softmax_loss_chunked(a, b, 0.05, chunk=chunk), t, v)
    _assert_same(j, p)
    np.testing.assert_allclose(p[0], float(full), atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="square"):
        pc.norm_softmax_loss_chunked(torch.from_numpy(t), torch.from_numpy(v[:5]))


@pytest.mark.parametrize("fix_norm", [True, False])
def test_max_margin_ranking_loss_matches_oatx(fix_norm):
    s = np.random.default_rng(3).uniform(-1, 1, (7, 7)).astype(np.float32)
    j, p = _value_and_grads(lambda a: jc.max_margin_ranking_loss(a, 0.3, fix_norm),
                            lambda a: pc.max_margin_ranking_loss(a, 0.3, fix_norm), s)
    _assert_same(j, p)


# ---------------------------------------------------------------- schedules

@pytest.mark.parametrize("kw", [
    dict(kind="step", milestones=(2, 5), gamma=0.1),
    dict(kind="step", milestones=(2, 5), gamma=0.5, warmup_steps=7),
    dict(kind="cosine", warmup_steps=3, lr_min=1e-5),
    dict(kind="cosine"),
    dict(kind="constant", warmup_steps=4),
], ids=["step", "step-warmup", "cosine-warmup", "cosine", "constant-warmup"])
def test_schedules_match_oatx_at_their_boundaries(kw):
    args = (3e-4, 10, 8)  # base lr, steps per epoch, epochs
    want = joptim.make_schedule(*args, **kw)
    got = poptim.make_schedule(*args, **kw)
    counts = [0, 1, 2, 3, 4, 6, 7, 8, 19, 20, 21, 27, 49, 50, 51, 57, 79, 80, 81, 500]
    np.testing.assert_allclose([got(c) for c in counts],
                               [float(want(jnp.int32(c))) for c in counts],
                               rtol=1e-6, atol=1e-9)
    with pytest.raises(ValueError):
        poptim.make_schedule(*args, kind="linear")


# ---------------------------------------------------------------- AdamW

NAMES = {"txt_proj.1.weight": (4, 3), "txt_proj.1.bias": (4,),
         "video_model.blocks.0.mlp.fc1.weight": (6, 5), "video_model.norm.bias": (5,),
         "text_model.embeddings.word_embeddings.weight": (7, 3)}


@pytest.mark.parametrize("kw", [
    dict(), dict(grad_clip=0.5), dict(grad_clip=1e3),
    dict(trainable_filter=poptim.linear_probe_filter),
    dict(ema_decay=0.9), dict(weight_decay=0.3, betas=(0.8, 0.95), eps=1e-6),
    dict(schedule=True),
], ids=["adamw", "clip-on", "clip-off", "freeze", "ema", "hparams", "schedule"])
def test_adamw_matches_optax_on_the_same_gradients(kw):
    """Five steps on identical gradients; on step 3 one parameter has no
    gradient in the port (None) and a zero gradient in optax, which is what
    optax sees for an unused parameter."""
    rng = np.random.default_rng(7)
    init = {n: rng.standard_normal(s).astype(np.float32) for n, s in NAMES.items()}
    lr = 1e-2
    if kw.pop("schedule", False):
        lr = poptim.make_schedule(1e-2, 2, 3, kind="cosine", warmup_steps=2)
        jlr = joptim.make_schedule(1e-2, 2, 3, kind="cosine", warmup_steps=2)
    else:
        jlr = lr
    jfilter = kw.get("trainable_filter") and joptim.linear_probe_filter
    tx = joptim.make_optimizer(lr=jlr, **{**kw, "trainable_filter": jfilter})
    jparams = {n: jnp.asarray(a) for n, a in init.items()}
    jstate = tx.init(jparams)
    tparams = {n: torch.nn.Parameter(torch.from_numpy(a.copy())) for n, a in init.items()}
    opt = poptim.make_optimizer(lr=lr, **kw)(tparams.items())
    update = jax.jit(tx.update)
    for step in range(5):
        grads = {n: (rng.standard_normal(s) * (step + 1)).astype(np.float32)
                 for n, s in NAMES.items()}
        if step == 2:
            grads["video_model.norm.bias"][:] = 0
        upd, jstate = update({n: jnp.asarray(g) for n, g in grads.items()}, jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, upd)
        for n, p in tparams.items():
            p.grad = None if (step == 2 and n == "video_model.norm.bias") \
                else torch.from_numpy(grads[n])
        opt.step()
    adam = jstate
    while not hasattr(adam, "mu"):
        adam = next(s for s in adam if isinstance(s, tuple) and s)
    named = opt.named_state()
    assert named["count"] == int(adam.count) == 5
    for n in NAMES:
        for got, want in ((tparams[n], jparams[n]), (named["mu"][n], adam.mu[n]),
                          (named["nu"][n], adam.nu[n])):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7, err_msg=n)
    if kw.get("ema_decay"):
        want_ema = joptim.find_ema(jstate)
        for n in NAMES:
            np.testing.assert_allclose(named["ema"][n].numpy(), np.asarray(want_ema[n]),
                                       rtol=1e-6, atol=1e-7, err_msg=n)
    if kw.get("trainable_filter"):
        frozen = [n for n in NAMES if "proj" not in n]
        assert all(np.array_equal(tparams[n].detach().numpy(), init[n]) for n in frozen)


def test_adamw_state_round_trips():
    p = torch.nn.Parameter(torch.ones(3))
    opt = poptim.make_optimizer(lr=0.1, ema_decay=0.5)([("w", p)])
    p.grad = torch.full((3,), 2.0)
    opt.step()
    other = poptim.make_optimizer(lr=0.1, ema_decay=0.5)([("w", torch.nn.Parameter(p.detach().clone()))])
    other.load_named_state(opt.named_state())
    a, b = opt.named_state(), other.named_state()
    assert a["count"] == b["count"] == 1
    assert all(torch.equal(a[k]["w"], b[k]["w"]) for k in ("mu", "nu", "ema"))


def test_optimizer_kinds_and_filters():
    for kind, cls in (("adafactor", poptim.Adafactor), ("Lion", poptim.Lion),
                      ("SGD", poptim.SGD), ("AdamW", poptim.AdamW)):
        opt = poptim.make_optimizer(kind=kind)([("w", torch.nn.Parameter(torch.ones(3)))])
        assert type(opt) is cls
    with pytest.raises(ValueError):
        poptim.make_optimizer(kind="rmsprop")
    with pytest.raises(ValueError):
        poptim.make_optimizer(ema_decay=1.5)
    paths = [("txt_proj", "1", "weight"), ("vid_proj", "0", "bias"), ("video_model", "norm"),
             ("object_tower", "x"), ()]
    for base in (None, poptim.linear_probe_filter):
        jbase = base and joptim.linear_probe_filter
        got = poptim.exclude_subtrees(base, ("object_tower",))
        want = joptim.exclude_subtrees(jbase, ("object_tower",))
        assert [got(q) for q in paths] == [want(q) for q in paths]
