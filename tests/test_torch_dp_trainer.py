"""Data-parallel Trainer and cli.train across processes, on the CPU (gloo).

Two ranks of `Trainer.train()` over MemoryClips (each rank its shard, a
per-process batch of 4) against one process over the same global batches
(data/loader.py GlobalBatches: the two shards' batches concatenated in rank
order, batch 8): the same step losses, validation metrics and parameters;
checkpoints and tracker metrics from rank 0 alone; a 2-rank resume repeats
the loss terms. Then `python -m oatx_torch.cli.train` on two processes
under OATX_MULTIHOST=1 (oatx's three variables, a file:// rendezvous),
twice: rc 0, one run directory with the vocab, one tracker, and the same
per-epoch metrics in both runs (oatx's test_cli_multihost_two_process_run).
The ranks run tests/torch_dp_worker.py or the CLI, one thread each, with a
150 s limit per launch. Losses, gradient norms and metrics: 1e-5 relative
between 2 ranks and one process. Parameters are not compared across the
two: AdamW's first updates are ±lr·sign(g), and where g is 0 in real
arithmetic (a key bias under softmax) its sign is rounding noise in either.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_helpers import REPO, launch_dp

torch.set_num_threads(1)

RAW = {
    "name": "dp",
    "arch": {"type": "FrozenInTime", "args": {
        "video_params": {"model": "SpaceTimeTransformer", "arch_config": "base_patch16_224",
                         "num_frames": 2, "input_res": 32, "embed_dim": 32, "depth": 2,
                         "num_heads": 2, "time_init": "random"},
        "text_params": {"model": "distilbert-base-uncased", "vocab_size": 100, "dim": 32,
                        "hidden_dim": 64, "n_layers": 2, "n_heads": 2},
        "projection": "minimal", "projection_dim": 16, "load_checkpoint": ""}},
    "optimizer": {"type": "AdamW", "args": {"lr": 1e-3}},
    "loss": {"type": "NormSoftmaxLoss", "args": {}},
    "metrics": ["t2v_metrics", "v2t_metrics"],
    "trainer": {"epochs": 2, "save_period": 1, "verbosity": 1, "init_val": True,
                "precision": "f32", "seed": 0, "monitor": "min val_loss_0"},
}
CLIPS = dict(n=16, frames=2, canon=48)
BATCH = 4  # per rank: 2 steps an epoch over a shard of 8 clips


def _payload(tmp, **kw):
    return {"raw": RAW, "clips": CLIPS, "batch": BATCH, "log_dir": str(tmp / "log"), **kw}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """2 ranks, one process over their global batches, and 2 ranks resumed
    from the first run's checkpoint-epoch1. Each rank saves under its own
    directory, so what a rank other than 0 writes would show."""
    tmp = tmp_path_factory.mktemp("dp_trainer")
    two = launch_dp("trainer", 2, _payload(tmp / "two", save_dir=str(tmp / "two" / "ckpt{rank}")),
                    tmp / "two")
    one = launch_dp("trainer", 1, _payload(tmp / "one", save_dir=str(tmp / "one" / "ckpt"),
                                           global_batches=2), tmp / "one")
    resumed = launch_dp("trainer", 2, _payload(
        tmp / "resumed", save_dir=str(tmp / "resumed" / "ckpt{rank}"),
        resume=str(tmp / "two" / "ckpt0" / "checkpoint-epoch1")), tmp / "resumed")
    return tmp, two, one[0], resumed


def test_two_ranks_train_as_one_process(runs):
    _, two, one, _ = runs
    assert len(two[0]["steps"]) == len(one["steps"]) == 4
    # the ranks agree bitwise: every loss term and every parameter
    assert two[0]["steps"] == two[1]["steps"]
    assert all(torch.equal(v, two[1]["params"][k]) for k, v in two[0]["params"].items())
    for got, want in zip(two[0]["steps"], one["steps"]):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_two_ranks_validate_as_one_process(runs):
    """Each rank embeds its shard of the 16 clips; every rank gathers all
    rows (rank 0's, then rank 1's), so its metrics are one process's over
    the whole corpus."""
    _, two, one, _ = runs
    logs = [(two[r]["init_val"], one["init_val"]) for r in range(2)] + [
        (two[r]["hist"][e], one["hist"][e]) for r in range(2) for e in (1, 2)]
    for got, want in logs:
        keys = [k for k in want if k.startswith("val_")]
        assert keys and sorted(k for k in got if k.startswith("val_")) == sorted(keys)
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_rank_zero_alone_writes(runs):
    tmp, _, _, _ = runs
    assert not (tmp / "two" / "ckpt1").exists()
    assert sorted(os.listdir(tmp / "two" / "ckpt0")) == sorted(
        ["checkpoint-epoch1", "checkpoint-epoch1.meta.json", "checkpoint-epoch2",
         "checkpoint-epoch2.meta.json", "model_best", "model_best.meta.json"])
    log = tmp / "two" / "log"
    assert {"info_p0.log", "info_p1.log"} <= set(os.listdir(log))
    kinds = {r: [json.loads(line)["kind"] for line in
                 (log / f"tracker{r}" / "events.jsonl").read_text().splitlines()]
             for r in range(2)}
    assert kinds[0].count("metrics") == 2  # one record per epoch
    assert "metrics" not in kinds[1]
    assert "Train Epoch" in (log / "info_p0.log").read_text()


def test_two_rank_resume_repeats_the_loss_terms(runs):
    """Both ranks restore rank 0's checkpoint-epoch1 and run epoch 2 again:
    the same loss terms, bitwise, and the same final parameters."""
    _, two, _, resumed = runs
    for r in range(2):
        assert resumed[r]["steps"] == two[0]["steps"][2:]
        assert all(torch.equal(v, two[0]["params"][k])
                   for k, v in resumed[r]["params"].items())


def test_preemption_on_one_rank_stops_both_at_one_step(tmp_path):
    """SIGTERM reaches rank 1 alone after its 3rd step (epoch 2, cycle 1):
    the ranks agree on the flag (collectives.any_rank), both stop after the
    same step, and rank 0 writes the mid-epoch snapshot behind a barrier."""
    ranks = launch_dp("trainer", 2, _payload(tmp_path, save_dir=str(tmp_path / "ckpt{rank}"),
                                             sigterm=(1, 3)), tmp_path)
    assert [len(r["steps"]) for r in ranks] == [3, 3]
    assert not (tmp_path / "ckpt1").exists()
    meta = json.loads((tmp_path / "ckpt0" / "preempt-epoch2.meta.json").read_text())
    assert (meta["epoch"], meta["cycles_done"], meta["step"]) == (2, 1, 3)
    assert (tmp_path / "ckpt0" / "preempt-epoch2" / "state.pt").exists()


def _cli_pair(cfg, tmp, timeout=150.0):
    """python -m oatx_torch.cli.train on 2 gloo ranks under OATX_MULTIHOST."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("OATX_")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", OATX_MULTIHOST="1",
               OATX_COORDINATOR=(tmp / "store").as_uri(), OATX_NUM_PROCESSES="2")
    procs = [subprocess.Popen([sys.executable, "-m", "oatx_torch.cli.train", "-c", cfg,
                               "--device", "cpu", "-o"], cwd=REPO,
                              env={**env, "OATX_PROCESS_ID": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
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
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
    return outs


def test_cli_train_on_two_processes(tmp_path):
    from oatx_torch.config.registry import DATASETS
    from oatx_torch.config.schema import DataLoaderCfg
    from oatx_torch.data.datasets import adapters  # noqa: F401 (registers them)

    with open(os.path.join(REPO, "configs", "smoke", "synthetic.json")) as f:
        raw = json.load(f)
    dl = raw["data_loader"][0]["args"]
    dl.update(data_dir=str(tmp_path / "videos"), object_dir="", num_workers=1)
    raw["trainer"].update(verbosity=1)
    # the clips are written once, here: both ranks then read them
    DATASETS.get("SyntheticVideoText")(DataLoaderCfg(
        dataset_name="SyntheticVideoText", data_dir=dl["data_dir"], num_workers=1,
        video_params=dl["video_params"], split="train"))
    epochs = {}
    for tag in ("a", "b"):
        raw["trainer"]["save_dir"] = str(tmp_path / tag)
        cfg = tmp_path / f"{tag}.json"
        cfg.write_text(json.dumps(raw))
        (tmp_path / tag).mkdir()
        _cli_pair(str(cfg), tmp_path / tag)
        [stamp] = os.listdir(tmp_path / tag / "models" / raw["name"])  # one run directory
        run = tmp_path / tag / "models" / raw["name"] / stamp
        log = tmp_path / tag / "log" / raw["name"] / stamp
        assert os.listdir(tmp_path / tag / "log" / raw["name"]) == [stamp]
        assert {"vocab.txt", "config.json", "checkpoint-epoch2"} <= set(os.listdir(run))
        assert {"info_p0.log", "info_p1.log", "events.jsonl"} <= set(os.listdir(log))
        events = [json.loads(line) for line in (log / "events.jsonl").read_text().splitlines()]
        assert [e["kind"] for e in events].count("run_start") == 1  # rank 0's tracker
        epochs[tag] = [e["metrics"] for e in events if e.get("mode") == "epoch"]
    assert len(epochs["a"]) == 2 and "loss_0" in epochs["a"][0]
    strip = [{k: v for k, v in m.items() if k not in ("epoch_time", "input_wait")}
             for m in epochs["a"]]
    assert strip == [{k: v for k, v in m.items() if k not in ("epoch_time", "input_wait")}
                     for m in epochs["b"]]
