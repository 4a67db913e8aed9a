"""The port's weight-only int8 serving (oatx_torch.serve.quant, EmbedService
quantize="int8", RetrievalIndex quantize="int8") and the kernels' custom
ops, against oatx on the CPU.

The same numpy-seeded oatx params go through oatx's `quantize_tree` and the
port's `quantize_model`: the set of quantized leaves, every int8 value and
every scale are equal exactly, at oatx's default min_elems and at toy ones
(6000 picks a depth-stacked leaf whose per-layer weight is smaller than
min_elems), and so is the byte report. The quantized services agree at the
towers' f32 atol 1e-4 (tests/test_torch_serve.py), the int8 corpora are
equal exactly, and their scores agree within 1e-5 with the same ranking.
"""

import json

import numpy as np
import pytest
import torch

from oatx.serve import embed_service as jes
from oatx.serve import quant as jq
from oatx.serve import retrieval_index as jri
from oatx_torch.models.convert import state_dict_from_oatx
from oatx_torch.ops.kernels import ln_linear as pll
from oatx_torch.ops.kernels import ln_mlp as plm
from oatx_torch.ops.kernels import space_attention as psa
from oatx_torch.serve import embed_service as pes
from oatx_torch.serve import quant as pq
from oatx_torch.serve import retrieval_index as pri
from torch_port_helpers import oatx_cfg, oatx_params, port_cfg, port_model, to_numpy

torch.set_num_threads(1)
ATOL = 1e-4


@pytest.fixture(scope="module")
def params():
    return oatx_params(oatx_cfg(), seed=2)


def _clips(n, seed=0, frames=2, canon=40):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, frames, canon, canon, 3), dtype=np.uint8)


def _port_layout(tree, marker):
    """oatx's quantized tree with each int8 marker node replaced by
    `marker(node)` (an f32 array of the kernel's shape), in the port's
    state_dict layout."""
    def walk(node):
        if jq.is_quantized_leaf(node):
            return marker(node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return np.zeros(np.shape(node), np.float32)
    return state_dict_from_oatx(walk(tree), port_cfg())


def _quantized_names(model):
    """The quantized weights, by the name of the parameter each replaced."""
    return [n[: -len("_q8")] for n, _ in model.named_buffers() if n.endswith("_q8")]


@pytest.mark.parametrize("min_elems", [4096, 6000, 64])
def test_quantized_leaves_values_and_scales_equal_oatx(params, min_elems):
    qtree = jq.quantize_tree(to_numpy(params), min_elems=min_elems)
    model = port_model(params)
    report = pq.quantize_model(model, min_elems=min_elems)
    flags = _port_layout(qtree, lambda n: np.ones(n["q8"].shape, np.float32))
    want_q = _port_layout(qtree, lambda n: n["q8"].astype(np.float32))
    want_s = _port_layout(qtree, lambda n: np.broadcast_to(n["q8_scale"], n["q8"].shape))
    names = _quantized_names(model)
    assert sorted(names) == sorted(k for k, v in flags.items() if bool(v.all()))
    for name in names:
        mod = model.get_submodule(name.rpartition(".")[0])
        leaf = name.rpartition(".")[2]
        q, scale = mod._buffers[leaf + "_q8"], mod._buffers[leaf + "_q8_scale"]
        assert q.dtype == torch.int8 and scale.dtype == torch.float32
        assert torch.equal(q.float(), want_q[name]), name
        assert torch.equal(scale.expand_as(q), want_s[name]), name
        assert leaf not in mod._parameters
    assert report == jq.quantization_report(to_numpy(params), qtree)
    if min_elems == 6000:  # a leaf oatx quantizes for its depth, not its layer
        assert any(model.get_submodule(n.rpartition(".")[0])._buffers[
            n.rpartition(".")[2] + "_q8"].numel() < min_elems for n in names)


def test_dequantized_weight_is_read_where_used(params):
    """A quantized weight is a property: q.float() · scale at each access,
    no parameter and no resident dequantized copy."""
    model = port_model(params)
    fc1 = model.video_model.blocks[0].mlp.fc1
    w = fc1.weight.detach().clone()
    pq.quantize_model(model)
    got = fc1.weight
    assert got.dtype == torch.float32 and got.shape == w.shape
    assert torch.equal(got, fc1.weight_q8.float() * fc1.weight_q8_scale)
    assert (got - w).abs().max() <= fc1.weight_q8_scale.max() / 2 + 1e-8
    assert "weight" not in dict(fc1.named_parameters())
    assert not any(t.dtype == torch.float32 and t.shape == w.shape
                   for t in fc1.buffers())


def test_quantize_model_refuses_an_empty_match(params):
    with pytest.raises(ValueError, match="no kernel"):
        pq.quantize_model(port_model(params), min_elems=10 ** 9)


@pytest.fixture(scope="module")
def q_services(params):
    jsvc = jes.EmbedService(params, oatx_cfg(), buckets=(1, 4), seq_len=8, scan_chunk=2,
                            quantize="int8")
    psvc = pes.EmbedService(port_model(params), port_cfg(), buckets=(1, 4), seq_len=8,
                            scan_chunk=2, quantize="int8", device="cpu")
    return jsvc, psvc


@pytest.mark.parametrize("n", [1, 3])
def test_quantized_service_video_matches_oatx(q_services, n):
    jsvc, psvc = q_services
    clips = _clips(n, seed=40 + n)
    np.testing.assert_allclose(psvc.embed_video(clips), jsvc.embed_video(clips),
                               atol=ATOL, rtol=0)


def test_quantized_service_text_matches_oatx(q_services, params):
    jsvc, psvc = q_services
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 100, (3, 8)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[2, 5:] = 0
    np.testing.assert_allclose(psvc.embed_text(ids, mask), jsvc.embed_text(ids, mask),
                               atol=ATOL, rtol=0)
    assert psvc.quant_report == jq.quantization_report(
        to_numpy(params), jq.quantize_tree(to_numpy(params)))


def test_quantized_service_min_elems_and_unknown_mode(params):
    svc = pes.EmbedService(port_model(params), port_cfg(), quantize="int8",
                           quant_min_elems=64, device="cpu")
    assert svc.quant_report["quantized_kernels"] == 15
    for make, kw in ((jes.EmbedService, {}), (pes.EmbedService, {"device": "cpu"})):
        model = params if make is jes.EmbedService else port_model(params)
        cfg = oatx_cfg() if make is jes.EmbedService else port_cfg()
        with pytest.raises(ValueError, match="unknown quantize mode"):
            make(model, cfg, quantize="int4", **kw)


# ---------------------------------------------------------------- index

@pytest.mark.parametrize("pad_multiple,score_chunk", [(64, 16384), (8, 16)],
                         ids=["unchunked", "chunked"])
def test_int8_corpus_equals_oatx(pad_multiple, score_chunk):
    rng = np.random.default_rng(pad_multiple + 1)
    emb = rng.standard_normal((50, 16)).astype(np.float32)
    ids = [f"v{i}" for i in range(50)]
    queries = rng.standard_normal((20, 16)).astype(np.float32)
    kw = dict(pad_multiple=pad_multiple, score_chunk=score_chunk, quantize="int8")
    jidx = jri.RetrievalIndex(emb, ids, **kw)
    pidx = pri.RetrievalIndex(emb, ids, device="cpu", **kw)
    (jc, js), (pc, ps) = jidx._corpus(), pidx._corpus()
    assert pc.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    assert pc.shape[0] > pidx.score_chunk or score_chunk > 50  # the chunked path runs
    for k in (1, 7):
        want, got = jidx.search(queries, k=k), pidx.search(queries, k=k)
        for wrow, grow in zip(want, got):
            ws = np.array([h["score"] for h in wrow])
            gs = np.array([h["score"] for h in grow])
            np.testing.assert_allclose(gs, ws, atol=1e-5, rtol=0)
            distinct = np.r_[np.diff(ws) < -1e-5, True] & np.r_[True, np.diff(ws) < -1e-5]
            assert [h["id"] for h, d in zip(grow, distinct) if d] == \
                [h["id"] for h, d in zip(wrow, distinct) if d]
    # the host copy stays exact f32
    np.testing.assert_array_equal(pidx._emb, jidx._emb)


def test_int8_index_save_load_crosses(tmp_path):
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((12, 8)).astype(np.float32)
    ids = [f"clip{i}" for i in range(12)]
    q = rng.standard_normal((3, 8)).astype(np.float32)
    jri.RetrievalIndex(emb, ids, pad_multiple=8, quantize="int8").save(str(tmp_path / "j.npz"))
    pidx = pri.RetrievalIndex.load(str(tmp_path / "j.npz"), device="cpu")
    assert pidx.quantize == "int8"
    pidx.add(emb[:2] * 3, ["extra0", "extra1"])  # re-derives the int8 corpus
    pidx.save(str(tmp_path / "p.npz"))
    jidx = jri.RetrievalIndex.load(str(tmp_path / "p.npz"))
    assert jidx.quantize == "int8" and jidx.ids == pidx.ids
    with np.load(str(tmp_path / "p.npz"), allow_pickle=True) as z:
        assert json.loads(str(z["meta"]))["quantize"] == "int8"
        np.testing.assert_array_equal(z["embeddings"], pidx._emb)  # the exact f32 copy
    want, got = jidx.search(q, 5), pidx.search(q, 5)
    np.testing.assert_allclose([[h["score"] for h in r] for r in got],
                               [[h["score"] for h in r] for r in want], atol=1e-5)
    # a load-time override serves an f32 file quantized, as oatx's does
    jri.RetrievalIndex(emb, ids, pad_multiple=8).save(str(tmp_path / "f32.npz"))
    over = pri.RetrievalIndex.load(str(tmp_path / "f32.npz"), quantize="int8", device="cpu")
    assert over.quantize == "int8" and over._corpus()[0].dtype == torch.int8
    with pytest.raises(ValueError, match="unknown quantize mode"):
        pri.RetrievalIndex(quantize="fp4", device="cpu")


# ------------------------------------------------------------ custom ops

def _randn(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _op_cases():
    rng = np.random.default_rng(0)
    cases = []
    for rows, d, dt in ((10, 64, torch.float32), (3, 32, torch.bfloat16)):
        cases.append(("ln_mlp", plm.ln_mlp_op, (
            _randn(rng, rows, d, dtype=dt), _randn(rng, d), _randn(rng, d),
            _randn(rng, 4 * d, d), _randn(rng, 4 * d), _randn(rng, d, 4 * d),
            _randn(rng, d), 1e-6)))
        cases.append(("ln_linear", pll.ln_linear_op, (
            _randn(rng, rows, d, dtype=dt), _randn(rng, d), _randn(rng, d),
            _randn(rng, 3 * d, d), _randn(rng, 3 * d), 1e-6)))
    for b, frames, n, h, dh in ((2, 2, 4, 2, 16), (1, 4, 3, 3, 8)):
        qkv = _randn(rng, b, 1 + frames * n, 3, h, dh)
        cases.append(("space_attention", psa.space_attention_op,
                      (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], frames, False)))
    return cases


@pytest.mark.parametrize("name,op,args", _op_cases(),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(_op_cases())])
def test_custom_op_fake_matches_cpu(name, op, args):
    """Each kernel's op: the fake implementation gives the CPU
    implementation's shapes and dtypes (torch.library.opcheck), and the CPU
    implementation is the plain version."""
    torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))
    got = op(*args)
    plain = {"ln_mlp": plm.ln_mlp_plain, "ln_linear": pll.ln_linear_plain,
             "space_attention": psa.space_attention_plain}[name]
    want = plain(*args[:4]) if name == "space_attention" else plain(*args)
    out = got[0] if name == "space_attention" else got
    assert torch.equal(out, want)
    meta = op(*[a.to("meta") if isinstance(a, torch.Tensor) else a for a in args])
    meta = meta[0] if name == "space_attention" else meta
    assert meta.shape == out.shape and meta.dtype == out.dtype


def test_custom_ops_are_registered():
    for name in ("ln_mlp", "ln_linear", "space_attention"):
        assert hasattr(torch.ops.oatx_torch, name)
