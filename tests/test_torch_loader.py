"""The port's loader stack (oatx_torch.data.loader) against oatx's: the same
dataset, seed, shard and epoch give the same batch order and the same
collated arrays, bit for bit; and device_prefetch on the CPU."""

import threading
import time

import numpy as np
import pytest
import torch

from oatx.data import loader as JL
from oatx.data.tokenizer import WordPieceTokenizer as JTok
from oatx_torch.data import loader as PL
from oatx_torch.data.tokenizer import WordPieceTokenizer as PTok
from torch_port_helpers import MemoryClips

torch.set_num_threads(1)


def _loaders(ds, **kw):
    jt = JTok.build_from_corpus(ds.captions, vocab_size=100)
    pt = PTok.build_from_corpus(ds.captions, vocab_size=100)
    kw.setdefault("num_workers", 2)
    return (JL.ShardedLoader(ds, collate=JL.Collator(jt, max_text_len=8), **kw),
            PL.ShardedLoader(ds, collate=PL.Collator(pt, max_text_len=8), **kw))


def _assert_same(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        if isinstance(w, tuple):  # (loader_index, batch) or (batch, n_valid)
            i = 0 if isinstance(w[0], dict) else 1
            assert g[1 - i] == w[1 - i]
            g, w = g[i], w[i]
        assert sorted(g) == sorted(w)
        for k in w:
            if k == "meta":
                assert g[k] == w[k]
            else:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("kw", [dict(batch_size=4, seed=3),
                                dict(batch_size=3, seed=1, num_shards=2, shard_id=1),
                                dict(batch_size=4, drop_last=False, shuffle=False),
                                dict(batch_size=2, seed=5, echo_factor=2)])
def test_sharded_loader_batches_equal_oatx(kw):
    ds = MemoryClips(n=22, roll=True)
    jl, pl = _loaders(ds, **kw)
    for epoch in (0, 2):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        assert len(pl) == len(jl)
        _assert_same(pl, jl)
        _assert_same(pl.iter_batches(1), jl.iter_batches(1))


@pytest.mark.parametrize("mode", [dict(), dict(cycle_shorter=True), dict(endless=True)])
def test_multi_loader_equals_oatx(mode):
    a, b = MemoryClips(n=12, roll=True), MemoryClips(n=20, seed=1, roll=True)
    (ja, pa), (jb, pb) = _loaders(a, batch_size=4, seed=2), _loaders(b, batch_size=4, seed=3)
    jm, pm = JL.MultiLoader([ja, jb], **mode), PL.MultiLoader([pa, pb], **mode)
    for m in (jm, pm):
        m.set_epoch(1)
    take = 14
    for skip in (0, 2):
        want = [x for _, x in zip(range(take), jm.iter_from(skip))]
        got = [x for _, x in zip(range(take), pm.iter_from(skip))]
        _assert_same(got, want)
    if not mode.get("endless"):
        assert len(pm) == len(jm)


def test_pad_batch_equals_oatx():
    ds = MemoryClips(n=7)
    jl, pl = _loaders(ds, batch_size=3, shuffle=False, drop_last=False)
    _assert_same(PL.padded_batches(iter(pl), 4), JL.padded_batches(iter(jl), 4))


def _threads_settle(baseline, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if threading.active_count() <= baseline:
            return True
        time.sleep(0.1)
    return False


def test_device_prefetch_on_the_cpu_passes_batches_through():
    ds = MemoryClips(n=9)
    _, pl = _loaders(ds, batch_size=2, shuffle=False, drop_last=False)
    want = list(PL.padded_batches(iter(pl), 2))
    got = list(PL.device_prefetch(PL.padded_batches(iter(pl), 2), device="cpu"))
    assert len(got) == len(want) == 5
    for (g, gn), (w, wn) in zip(got, want):
        assert gn == wn and g["meta"] == w["meta"]
        for k in ("video", "input_ids", "attention_mask"):
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), w[k])


def test_device_prefetch_raises_the_producers_error_and_joins():
    baseline = threading.active_count()

    def source():
        yield {"x": np.zeros(2)}
        raise OSError("decode failed")

    it = PL.device_prefetch(source(), device="cpu")
    assert torch.equal(next(it)["x"], torch.zeros(2, dtype=torch.float64))
    with pytest.raises(OSError, match="decode failed"):
        next(it)
    assert _threads_settle(baseline)
    # an abandoned epoch releases the producer and the loader's pool
    ds = MemoryClips(n=24)
    _, pl = _loaders(ds, batch_size=2)
    it = PL.device_prefetch(iter(PL.MultiLoader([pl])), device="cpu")
    next(it)
    it.close()
    assert _threads_settle(baseline)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card default")
def test_device_prefetch_needs_a_card_unless_told_cpu():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(PL.device_prefetch(iter([{"x": np.zeros(1)}])))
