"""`python -m oatx_torch.cli.average_checkpoints` against oatx's
tools/average_checkpoints.py.

oatx's Orbax snapshots do not restore in the port, so the arithmetic is
held against oatx's own `_tree_add` / `_tree_cast` on the same arrays
(exactly: both sum in float64 with weight 1/N and cast back), and the file
format against the port's own loader: `import_initial_weights` reads the
output into a DualTower. Snapshots are the Trainer's (`save_checkpoint`
of an `init_state`).
"""

from __future__ import annotations

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from oatx_torch.cli import average_checkpoints as cli
from oatx_torch.models.towers import DualTower
from oatx_torch.train import checkpoint as ckptlib
from oatx_torch.train import optim as optimlib
from oatx_torch.train import step as steplib
from torch_port_helpers import port_cfg

HERE = os.path.dirname(os.path.abspath(__file__))


def _oatx_tool():
    spec = importlib.util.spec_from_file_location(
        "oatx_average_checkpoints", os.path.join(HERE, "..", "tools", "average_checkpoints.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _snapshots(tmp_path, n, ema_decay=None):
    """n Trainer snapshots of the tiny towers, each from its own seed; with
    an EMA, each EMA moved off its parameters."""
    torch.set_num_threads(1)
    paths, states = [], []
    for i in range(n):
        state = steplib.init_state(port_cfg(), optimlib.make_optimizer(ema_decay=ema_decay),
                                   device="cpu", generator=torch.Generator().manual_seed(i))
        if ema_decay:
            g = torch.Generator().manual_seed(100 + i)
            for p in state.optimizer.param_groups[0]["params"]:
                ema = state.optimizer.state[p]["ema"]
                ema.add_(torch.randn(ema.shape, generator=g))
        paths.append(str(ckptlib.save_checkpoint(tmp_path, f"checkpoint-epoch{i + 1}", state,
                                                 i + 1, 0.0)))
        states.append(torch.load(os.path.join(paths[-1], ckptlib.STATE_FILE),
                                 weights_only=True))
    return paths, states


def _run(argv, capsys):
    rc = cli.main(argv)
    return rc, capsys.readouterr()


@pytest.mark.parametrize("n", [2, 3])
def test_average_matches_oatx_arithmetic(tmp_path, n, capsys):
    paths, states = _snapshots(tmp_path, n)
    out = tmp_path / "soup"
    rc, said = _run([*paths, "--out", str(out), "--device", "cpu"], capsys)
    assert rc == 0
    line = json.loads(said.out.strip().splitlines()[-1])
    sds = [s["model"] for s in states]
    assert line == {"out": str(out.resolve()), "averaged": n, "param_tensors": len(sds[0]),
                    "source": "params"}
    tool = _oatx_tool()
    trees = [{k: v.numpy() for k, v in sd.items()} for sd in sds]
    acc = None
    for tree in trees:
        acc = tool._tree_add(acc, tree, 1.0 / n)
    want = tool._tree_cast(acc, trees[0])
    got = torch.load(out / ckptlib.STATE_FILE, weights_only=True)["model"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == sds[0][k].dtype
        np.testing.assert_array_equal(got[k].numpy(), v)
    # the file is a snapshot the port's loader reads
    model = DualTower(port_cfg(), device="cpu")
    ckptlib.import_initial_weights(str(out), model)
    for k, v in model.state_dict().items():
        assert torch.equal(v, got[k]), k


def test_average_of_emas(tmp_path, capsys):
    paths, states = _snapshots(tmp_path, 2, ema_decay=0.9)
    out = tmp_path / "ema_soup"
    rc, said = _run([*paths, "--out", str(out), "--ema", "--device", "cpu"], capsys)
    assert rc == 0 and json.loads(said.out.splitlines()[-1])["source"] == "ema"
    got = torch.load(out / ckptlib.STATE_FILE, weights_only=True)["model"]
    tool = _oatx_tool()
    trees = [{k: v.numpy() for k, v in {**s["model"], **s["optimizer"]["ema"]}.items()}
             for s in states]
    want = tool._tree_cast(tool._tree_add(tool._tree_add(None, trees[0], 0.5), trees[1], 0.5),
                           trees[0])
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    assert not all(torch.equal(got[k], (states[0]["model"][k] + states[1]["model"][k]) / 2)
                   for k in states[0]["optimizer"]["ema"])


def test_missing_ema_exits_1(tmp_path, capsys):
    paths, _ = _snapshots(tmp_path, 2)
    rc, said = _run([*paths, "--out", str(tmp_path / "x"), "--ema", "--device", "cpu"], capsys)
    assert rc == 1 and "carries no EMA state" in said.err
    assert not (tmp_path / "x").exists()


def test_refuses_the_cpu_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([str(tmp_path), "--out", str(tmp_path / "x")])
