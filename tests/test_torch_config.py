"""The port's experiment config (oatx_torch.config: schema, parser, registry)
against oatx's: every JSON under configs/ loads to the same field values, and
CLI overrides, experiment directories and resume paths resolve the same."""

import dataclasses
import glob
import json
import os

import pytest

from oatx.config import parser as jparser
from oatx.config import schema as jschema
from oatx_torch.config import parser as pparser
from oatx_torch.config import registry as pregistry
from oatx_torch.config import schema as pschema

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.json"), recursive=True))
NORM = os.path.join(REPO, "configs", "pt", "cc3m_webvid", "norm.json")


def _fields(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k != "raw"}


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.relpath(p, REPO) for p in CONFIGS])
def test_every_config_loads_to_oatx_values(path):
    want = jschema.ExperimentCfg.from_json(path)
    got = pschema.ExperimentCfg.from_json(path)
    assert _fields(got) == _fields(want)
    assert got.raw == want.raw
    for a, b in zip(got.data_loaders, want.data_loaders):
        assert (a.input_res, a.num_frames, a.loading) == (b.input_res, b.num_frames, b.loading)


def test_the_schemas_have_oatx_fields():
    for name in ("VideoParamsCfg", "TextParamsCfg", "ObjectParamsCfg", "ArchCfg",
                 "DataLoaderCfg", "OptimizerCfg", "LossCfg", "TrainerCfg", "ExperimentCfg"):
        want = [(f.name, f.default) for f in dataclasses.fields(getattr(jschema, name))]
        got = [(f.name, f.default) for f in dataclasses.fields(getattr(pschema, name))]
        assert got == want, name
    with pytest.raises(ValueError, match="milestones"):
        pschema.OptimizerCfg.from_dict({"args": {"schedule": [60, 80]}})


def _write(tmp_path, sub):
    with open(NORM) as f:
        raw = json.load(f)
    raw["trainer"]["save_dir"] = str(tmp_path / sub / "exps")
    path = tmp_path / f"{sub}.json"
    path.write_text(json.dumps(raw))
    return path


@pytest.mark.parametrize("extra", [["--lr", "0.001", "--bs", "4", "--epochs", "7",
                                    "--schedule", "3,5"],
                                   ["--schedule", "cosine", "--learning_rate", "3e-5"]])
def test_overrides_and_directories_match_oatx(tmp_path, extra):
    out = {}
    for name, parser in (("oatx", jparser), ("port", pparser)):
        path = _write(tmp_path, name)
        exp = parser.load_experiment(["-c", str(path), "--no_timestamp"] + extra)
        rel = [os.path.relpath(d, tmp_path / name) for d in
               (exp.save_dir, exp.log_dir, exp.web_dir)]
        snap = json.loads((exp.save_dir / "config.json").read_text())
        snap["trainer"].pop("save_dir")
        out[name] = (_fields(exp.cfg), rel, exp.log_dir.is_dir(), snap)
        out[name][0]["trainer"].pop("save_dir")
    assert out["port"] == out["oatx"]


def test_timestamped_dirs_and_test_mode(tmp_path):
    path = _write(tmp_path, "ts")
    exp = pparser.load_experiment(["-c", str(path)], test=True)
    assert len(exp.save_dir.name) == len("1017_073000") and not exp.save_dir.exists()
    with pytest.raises(SystemExit):
        pparser.load_experiment([], test=True)


def test_resume_reads_the_snapshot_config_like_oatx(tmp_path):
    with open(NORM) as f:
        raw = json.load(f)
    run = tmp_path / "run"
    run.mkdir()
    (run / "config.json").write_text(json.dumps(raw))
    (run / "checkpoint-epoch3").mkdir()
    upd = tmp_path / "upd.json"
    upd.write_text(json.dumps({"name": "renamed"}))
    for argv in (["-r", str(run / "checkpoint-epoch3")],
                 ["-r", str(run / "checkpoint-epoch3"), "-c", str(upd), "--bs", "2"]):
        want = jparser.load_experiment(argv, test=True)
        got = pparser.load_experiment(argv, test=True)
        assert got.resume == want.resume == run / "checkpoint-epoch3"
        assert _fields(got.cfg) == _fields(want.cfg)
        assert (got.save_dir, got.log_dir) == (want.save_dir, want.log_dir) or \
            got.cfg.name == want.cfg.name  # the timestamp may tick between the two


def test_registry():
    r = pregistry.Registry("thing")
    r.add("a", 1)
    assert r.get("a") == 1 and "a" in r and r.names() == ["a"]
    with pytest.raises(KeyError, match="registered: a"):
        r.get("b")
    r.register("f")(len)
    with pytest.raises(ValueError, match="already registered"):
        r.register("f")(len)
    assert pregistry.METRICS.names() == ["mean_average_precision",
                                         "retrieval_as_classification",
                                         "t2v_metrics", "v2t_metrics"]
