"""The port's host-side leftovers against oatx on the CPU: the multi-crop
slices (`oatx_torch/data/crops.py`, bit for bit), the text augmentations
(`oatx_torch/data/text_aug.py`, the same string and the same generator
state from the same seed), and `tsne_embedding_plot` with its numpy t-SNE
(`oatx_torch/visualization/tsne.py`) against sklearn and matplotlib, which
oatx uses and the card's machine lacks.

oatx's `_synonym` reads nltk's WordNet where its data is installed; the
port never does (ROADMAP's divergences). The text tests patch oatx's
`_synonym` to `lambda w: None`, its fallback, so they hold whatever nltk
data is installed.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from oatx.data import crops as jcrops
from oatx.data import text_aug as jta
from oatx_torch.data import crops as pcrops
from oatx_torch.data import text_aug as pta
from oatx_torch.visualization import plots as pplots
from oatx_torch.visualization import tsne as ptsne
from oatx_torch.visualization.png import read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = range(60)
CAPTIONS = ("a brown dog runs across the green field while two children chase it",
            "dog", "two dogs", "", "  spaced   out words  ")
TAGS = ("dog cat car tree person", "dog", "")
VOCAB = ("zebra", "lamp", "boat")
# the port's joint P against sklearn's, relative to each entry (measured
# ≤ 1e-15: the same float32 distances and float64 search)
JOINT_RTOL = 1e-6
# the port's exact t-SNE against sklearn's TSNE(method="exact", init="pca",
# random_state=0) on 3 Gaussian clusters of 30 points in 16-d: the same start
# and updates in another summation order, so the embeddings part after a few
# hundred iterations. Trustworthiness (5 neighbours) within TRUST_MARGIN and
# the final KL within KL_FACTOR either way (measured 0.9556 against 0.9560,
# 0.407 against 0.435)
TRUST_MARGIN = 0.02
KL_FACTOR = 1.25


@pytest.mark.parametrize("shape,size", [((2, 100, 160, 3), 96), ((2, 100, 160, 3), 64),
                                        ((3, 101, 157, 3), 33), ((1, 64, 64, 3), 64),
                                        ((64, 99, 3), 64), ((4, 2, 75, 75, 3), 74)],
                         ids=["even", "five-crop", "odd", "side", "one-frame", "leading"])
def test_crops_match_oatx_bitwise(shape, size):
    frames = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    pairs = [(pcrops.center_crop_np(frames, size), jcrops.center_crop_np(frames, size))]
    pairs += zip(pcrops.border_crops(frames, size), jcrops.border_crops(frames, size))
    pairs += zip(pcrops.two_hori_crop(frames, size), jcrops.two_hori_crop(frames, size))
    assert len(pairs) == 8
    for got, want in pairs:
        assert got.shape == want.shape and got.shape[-3:] == (size, size, 3)
        np.testing.assert_array_equal(got, want)
        assert np.shares_memory(got, frames)  # a view, as oatx's


def _same(port_fn, oatx_fn, seed, *args, **kw):
    """Both functions on fresh generators of `seed`: the same result (or
    the same exception type) and the same generator state after."""
    rp, rj = np.random.default_rng(seed), np.random.default_rng(seed)
    try:
        want = oatx_fn(*args, rng=rj, **kw)
    except Exception as e:  # noqa: BLE001 — the port must raise alike
        with pytest.raises(type(e)):
            port_fn(*args, rng=rp, **kw)
        return
    assert port_fn(*args, rng=rp, **kw) == want
    assert rp.bit_generator.state == rj.bit_generator.state


TEXT_CASES = {
    "eda": lambda: [((c,), {}) for c in CAPTIONS] + [((CAPTIONS[0],), {"alpha": 0.3})],
    "random_swap": lambda: [((c.split(), n), {}) for c in CAPTIONS for n in (1, 3)],
    "random_delete": lambda: [((c.split(), p), {}) for c in CAPTIONS for p in (0.1, 0.9)],
    "random_insert": lambda: [((c.split(), n), {}) for c in CAPTIONS for n in (1, 2)],
    "synonym_replace": lambda: [((c.split(), n), {}) for c in CAPTIONS for n in (1, 2)],
    "shuffle_object_tags": lambda: [((t,), {}) for t in TAGS],
    "add_pseudo_class": lambda: [((t, VOCAB), {"n": n}) for t in TAGS for n in (1, 3)],
    "mask_words": lambda: [((c,), {"p": p}) for c in CAPTIONS for p in (0.15, 1.0)],
}


@pytest.mark.parametrize("name", sorted(TEXT_CASES))
def test_text_aug_matches_oatx(name, monkeypatch):
    monkeypatch.setattr(jta, "_synonym", lambda w: None)  # oatx's fallback (docstring)
    port_fn, oatx_fn = getattr(pta, name), getattr(jta, name)
    for args, kw in TEXT_CASES[name]():
        for seed in SEEDS:
            _same(port_fn, oatx_fn, seed, *args, **kw)


def _clusters(n_per=30, dim=16, k=3, seed=0):
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 6, (k, dim))
    x = np.concatenate([c + rng.normal(0, 1, (n_per, dim)) for c in centres])
    return x, np.repeat(np.arange(k), n_per)


@pytest.mark.parametrize("perplexity", [2.0, 10.0, 29.0])
def test_joint_probabilities_match_sklearn(perplexity):
    from sklearn.manifold._t_sne import _joint_probabilities
    from sklearn.metrics import pairwise_distances

    x, _ = _clusters()
    want = _joint_probabilities(pairwise_distances(x, squared=True), perplexity, 0)
    got = ptsne.joint_probabilities(ptsne.squared_distances(x), perplexity)
    np.testing.assert_allclose(got, want, rtol=JOINT_RTOL, atol=0)


def test_tsne_quality_matches_sklearn_exact():
    from sklearn.decomposition import PCA
    from sklearn.manifold import TSNE, trustworthiness

    x, _ = _clusters()
    start = PCA(n_components=2, random_state=0).fit_transform(x).astype(np.float32)
    np.testing.assert_allclose(ptsne.pca_init(x), start / np.std(start[:, 0]) * 1e-4,
                               rtol=1e-5, atol=1e-10)
    sk = TSNE(n_components=2, perplexity=10.0, init="pca", random_state=0, method="exact")
    want = sk.fit_transform(x)
    got, kl = ptsne.tsne(x, perplexity=10.0)
    assert got.shape == (len(x), 2) and got.dtype == np.float32 and np.isfinite(got).all()
    t_got, t_want = (trustworthiness(x, y, n_neighbors=5) for y in (got, want))
    assert abs(t_got - t_want) <= TRUST_MARGIN, (t_got, t_want)
    assert sk.kl_divergence_ / KL_FACTOR <= kl <= sk.kl_divergence_ * KL_FACTOR, \
        (kl, sk.kl_divergence_)


@pytest.mark.parametrize("labelled", [True, False], ids=["labels", "no-labels"])
def test_tsne_plot_png(tmp_path, labelled):
    """The PNG reads back at 720 × 720; the pixel under each point's centre
    has the colour matplotlib's tab10 gives its label (normalised over the
    labels' range), or that of the last point drawn over it; the strip
    holds all ten colours when there are labels."""
    import matplotlib

    x, labels = _clusters(n_per=10, k=3, seed=1)
    labels = labels * 2 + 1 if labelled else None
    path = pplots.tsne_embedding_plot(x, labels=labels, out_path=str(tmp_path / "t.png"))
    img = read_png(path)
    assert img.shape == (720, 720, 3)
    xy, _ = ptsne.tsne(x, perplexity=min(10.0, max(1, len(x) // 3), len(x) - 1))
    centres = ptsne.scatter_centres(xy)
    if labelled:
        norm = matplotlib.colors.Normalize(labels.min(), labels.max())
        rgba = matplotlib.colormaps["tab10"](norm(labels))
    else:
        rgba = np.repeat([matplotlib.colors.to_rgba("C0")], len(x), axis=0)
    colours = np.round(np.asarray(rgba)[:, :3] * 255).astype(np.uint8)
    r2 = ptsne.MARKER_RADIUS ** 2
    for i, (cx, cy) in enumerate(centres):
        px, py = int(cx), int(cy)
        over = [j for j in range(len(x))
                if (px + 0.5 - centres[j, 0]) ** 2 + (py + 0.5 - centres[j, 1]) ** 2 <= r2]
        np.testing.assert_array_equal(img[py, px], colours[over[-1]], err_msg=f"point {i}")
    sl, st, sr, sb = ptsne.STRIP
    strip = {tuple(c) for c in img[st:sb, sl:sr].reshape(-1, 3)}
    assert ({tuple(c) for c in ptsne.TAB10} <= strip) == labelled
    assert (img[:ptsne.AXES[1]] == 0).all(-1).any()  # the title


def test_tsne_clamp_and_small_n_as_oatx(tmp_path, monkeypatch):
    """n < 2 raises ValueError in both; otherwise both hand their t-SNE
    min(perplexity, max(1, n // 3), n − 1)."""
    import sklearn.manifold

    from oatx.visualization import plots as jplots

    seen = {"oatx": [], "port": []}

    class Recorder:
        def __init__(self, **kw):
            seen["oatx"].append(kw["perplexity"])
            assert kw["init"] == "pca" and kw["random_state"] == 0

        def fit_transform(self, x):
            return np.random.default_rng(0).normal(size=(len(x), 2))

    monkeypatch.setattr(sklearn.manifold, "TSNE", Recorder)
    monkeypatch.setattr(ptsne, "tsne", lambda x, perplexity: (
        seen["port"].append(perplexity) or np.random.default_rng(0).normal(size=(len(x), 2)),
        0.0))
    for n in (0, 1):
        for mod in (jplots, pplots):
            with pytest.raises(ValueError):
                mod.tsne_embedding_plot(np.zeros((n, 4)), out_path=str(tmp_path / "x.png"))
    for n in (2, 3, 7, 40):
        for perplexity in (10.0, 2.5):
            x = np.random.default_rng(n).normal(size=(n, 4))
            for name, mod in (("oatx", jplots), ("port", pplots)):
                mod.tsne_embedding_plot(x, labels=np.arange(n) % 3, perplexity=perplexity,
                                        out_path=str(tmp_path / f"{name}.png"))
    assert seen["port"] == seen["oatx"] and len(seen["port"]) == 8
    assert seen["port"][:2] == [1, 1] and seen["port"][-2:] == [10.0, 2.5]


def test_aux_modules_import_no_plotting_or_nlp_packages():
    """A fresh interpreter imports the new modules without nltk, sklearn,
    matplotlib or PIL (the card's machine has none of them), nor jax or
    oatx."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import oatx_torch.data.crops, oatx_torch.data.text_aug, "
            "oatx_torch.visualization.plots, oatx_torch.visualization.tsne; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('nltk', 'sklearn', 'matplotlib', 'PIL', 'jax', 'oatx')); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-I", "-c", code, REPO], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
