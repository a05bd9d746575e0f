"""The port's dataset-to-deployment CLIs end to end on the CPU, held against
the JAX package's where both run.

``cli.download alerts`` (a fake Kowalski client) writes four source sets;
``cli.dataset build`` splits them (its files equal the JAX CLI's);
``cli.dataset subset`` / ``subsample`` / ``to-hf`` equal the JAX CLI's;
``cli.train`` trains a tiny um_nn on the built split; ``cli.export`` writes
the ONNX artifact (verified against the port's forward) and the
reference-named ``pytorch_model.bin``, and refuses ``saved_model``;
``cli.publish --no-upload`` prepares the directory ``interop.hf.load_model_dir``
loads; ``interop.publish`` uploads through an injected API.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from btsbot_tpu.cli.dataset import main as jax_dataset_cli
from btsbot_tpu.interop import publish as jax_publish
from btsbot_tpu_torch.cli.dataset import main as dataset_cli
from btsbot_tpu_torch.cli.download import main as download_cli
from btsbot_tpu_torch.cli.export import main as export_cli
from btsbot_tpu_torch.cli.publish import main as publish_cli
from btsbot_tpu_torch.cli.train import main as train_cli
from btsbot_tpu_torch.data.dataset import read_candidates, write_candidates
from btsbot_tpu_torch.data.query import kowalski
from btsbot_tpu_torch.engine.checkpoint import BEST_MODEL, load_torch_checkpoint
from btsbot_tpu_torch.interop import publish
from btsbot_tpu_torch.interop.hf import load_model_dir
from btsbot_tpu_torch.interop.onnx_export import port_logits
from btsbot_tpu_torch.metrics.report import make_report
from btsbot_tpu_torch.models.factory import build_model

import torch_stub_sessions as stubs

SETS = {"trues": 17.6, "dims": 18.9, "vars": 17.0, "rejects": 18.2}   # peak magnitude
META_COLS = ["magpsf", "sigmapsf", "drb", "sgscore1", "age", "days_since_peak",
             "days_to_peak", "peakmag_so_far", "maxmag_so_far", "nnotdet", "ncovhist",
             "ndethist"]
UM_NN = {"model_name": "um_nn", "train_data_version": "vt", "metadata_cols": META_COLS,
         "meta_fc1_neurons": 16, "meta_fc2_neurons": 8, "meta_dropout": 0.1,
         "batch_size": 16, "epochs": 2, "learning_rate": 1e-3, "beta_1": 0.9, "beta_2": 0.999,
         "warmup_epochs": 0, "patience": 5, "random_seed": 2}


@pytest.fixture
def round_trip_pandas(monkeypatch):
    """The JAX CLIs read CSVs with pandas: its round-trip parser reads the
    values the port reads (the default one rounds some 17-digit floats one
    ulp off; tests/test_torch_data_layer.py)."""
    read_csv = pd.read_csv
    monkeypatch.setattr(pd, "read_csv",
                        lambda *a, **k: read_csv(*a, float_precision="round_trip", **k))


def _set_packets(name, peak, n_obj=12):
    packets = {}
    for o in range(n_obj):
        oid = f"ZTF24{name[:3]}{o:03d}"
        packets[oid] = [stubs.alert_packet(
            100 * o + i, objid=oid, programid=1 + i % 2, candid=1000 * o + i,
            jd=2459500.5 + o + 0.5 * i, magpsf=round(peak + 0.3 * abs(i - 1) + 0.01 * o, 3),
            jdstarthist=2459490.0 + o, sgscore1=0.2 + 0.01 * i, drb=0.5 + 0.1 * i, size=8)
            for i in range(3)]
    return packets


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Base data written by cli.download, then cli.dataset build by both
    packages (seed 0: one object of each set in val, one in test)."""
    root = tmp_path_factory.mktemp("lifecycle")
    base, data = str(root / "base"), str(root / "data")
    os.makedirs(base)
    for name, peak in SETS.items():
        packets = _set_packets(name, peak)
        ids = np.asarray(list(packets))
        types = np.where(np.arange(len(ids)) % 3 == 0, "AGN", "SN Ia")   # the source list's
        write_candidates({"ZTFID": ids, "type": types}, os.path.join(base, f"{name}.csv"))
        client = stubs.FakeKowalski(packets)
        real = kowalski.client_from_env
        kowalski.client_from_env = lambda: client
        try:
            download_cli(["alerts", name, "--base-dir", base, "--device", "cpu"])
        finally:
            kowalski.client_from_env = real
    dataset_cli(["build", "--version", "vt", "--base-dir", base, "--out-dir", data,
                 "--seed", "0"])
    read_csv = pd.read_csv
    pd.read_csv = lambda *a, **k: read_csv(*a, float_precision="round_trip", **k)
    try:
        jax_dataset_cli(["build", "--version", "vt", "--base-dir", base, "--out-dir",
                         str(root / "jax"), "--seed", "0"])
    finally:
        pd.read_csv = read_csv
    return root


def _same_files(dir_a, dir_b, names):
    for name in names:
        a, b = os.path.join(dir_a, name), os.path.join(dir_b, name)
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b))
        else:
            with open(a) as fa, open(b) as fb:
                assert fa.read() == fb.read(), name


def test_download_and_build_match_the_jax_cli(built):
    base = built / "base"
    for name in SETS:
        trips = np.load(base / f"{name}_triplets.npy")
        cand = read_candidates(str(base / f"{name}_candidates.csv"))
        assert trips.shape == (36, 63, 63, 3) and trips.dtype == np.float64
        assert set(cand["label"]) == {int(name == "trues")}
    names = sorted(os.listdir(built / "jax"))
    assert names == sorted(os.listdir(built / "data")) and len(names) == 12
    _same_files(built / "data", built / "jax", names)
    for split in ("train", "val", "test"):
        assert len(read_candidates(str(built / "data" / f"{split}_cand_vt_N100.csv"))["N"])


@pytest.mark.parametrize("argv", [
    ["subset", "--split", "train", "--n-max-p", "2", "--n-max-n", "1", "--rise-only"],
    ["subset", "--split", "val", "--n-max-p", "1", "--no-near-threshold"],
    ["subsample", "--split", "train", "--percent", "50"],
])
def test_subset_and_subsample_match_the_jax_cli(built, argv, tmp_path, round_trip_pandas):
    for pkg, out in ((dataset_cli, "torch"), (jax_dataset_cli, "jax")):
        work = tmp_path / out
        work.mkdir()
        for name in os.listdir(built / "data"):
            os.symlink(built / "data" / name, work / name)
        pkg(argv[:1] + ["--version", "vt", "--data-dir", str(work)] + argv[1:])
    new = sorted(n for n in os.listdir(tmp_path / "jax")
                 if not os.path.islink(tmp_path / "jax" / n))
    assert new == sorted(n for n in os.listdir(tmp_path / "torch")
                         if not os.path.islink(tmp_path / "torch" / n)) and len(new) == 2
    _same_files(tmp_path / "torch", tmp_path / "jax", new)


def test_to_hf_matches_the_jax_cli(built, tmp_path, round_trip_pandas):
    from datasets import load_from_disk

    for pkg, out in ((dataset_cli, "torch"), (jax_dataset_cli, "jax")):
        (tmp_path / out).mkdir()
        for name in ("train_cand_vt_N100.csv", "train_triplets_vt_N100.npy"):
            os.symlink(built / "data" / name, tmp_path / out / name)
        pkg(["to-hf", "--version", "vt", "--split", "train", "--data-dir", str(tmp_path / out)])
    got = load_from_disk(str(tmp_path / "torch" / "train_vt_N100"))
    want = load_from_disk(str(tmp_path / "jax" / "train_vt_N100"))
    assert got.features == want.features
    g, w = got.with_format("numpy")[:], want.with_format("numpy")[:]
    assert list(g) == list(w)
    for k in w:   # NaN-aware (the last_nondet_* columns)
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.fixture(scope="module")
def trained(built):
    cfg_path = str(built / "um_nn.json")
    with open(cfg_path, "w") as f:
        json.dump(UM_NN, f)
    result = train_cli([cfg_path, "--data-dir", str(built / "data"), "--out-root",
                        str(built / "models"), "--run-name", "r", "--no-figure",
                        "--device", "cpu"])
    return result["model_dir"]


def test_export_every_format(trained, capsys, monkeypatch):
    out = export_cli([trained, "--device", "cpu"])
    assert out == os.path.join(trained, "model.onnx")
    with open(os.path.join(trained, "model.verification.json")) as f:
        report = json.load(f)
    assert report["close"] and report["n"] == 16 and report["rtol"] == 1e-4
    assert "Verified vs the port's f32 forward" in capsys.readouterr().out

    out = export_cli([trained, "--format", "torch"])
    sd = load_torch_checkpoint(out)
    best = load_torch_checkpoint(os.path.join(trained, BEST_MODEL))
    assert sd.keys() == best.keys() and all(torch.equal(sd[k], best[k]) for k in sd)
    model = build_model(UM_NN, device="cpu")
    model.load_state_dict(sd, strict=True)

    out = export_cli([trained, "--format", "saved_model", "--device", "cpu"])
    assert out == os.path.join(trained, "saved_model")
    assert os.path.isfile(os.path.join(out, "saved_model.pb"))
    assert os.path.isdir(os.path.join(out, "variables"))
    with open(os.path.join(out, "verification.json")) as f:
        report = json.load(f)
    assert report["close"] and report["n"] == 16 and report["artifact"] == "tf_saved_model"
    assert "Verified vs the port's f32 forward" in capsys.readouterr().out
    # a forward that disagrees with the artifact fails the command
    from btsbot_tpu_torch.interop import savedmodel
    real = savedmodel.port_logits
    monkeypatch.setattr(savedmodel, "port_logits", lambda *a, **k: real(*a, **k) + 0.05)
    with pytest.raises(SystemExit, match="Verification FAILED"):
        export_cli([trained, "--format", "saved_model", "--device", "cpu"])


def test_publish_no_upload_then_load_model_dir(trained, capsys):
    publish_cli([trained, "--no-upload"])
    assert "no HF repo naming" in capsys.readouterr().out   # um_nn: local export only
    with open(os.path.join(trained, "train_config.json")) as f:
        assert json.load(f) == jax_publish.prep_config(trained)
    model, config = load_model_dir(trained, device="cpu")
    meta = np.random.default_rng(0).normal(size=(5, len(META_COLS))).astype(np.float32)
    with torch.no_grad():
        got = model(metadata_input=torch.from_numpy(meta)).reshape(-1).numpy()
    np.testing.assert_array_equal(
        got, port_logits(config, load_torch_checkpoint(os.path.join(trained, BEST_MODEL)),
                         None, meta, device="cpu"))


class StubHfApi:
    def __init__(self):
        self.repos, self.files = [], []

    def create_repo(self, repo_id, repo_type, exist_ok):
        self.repos.append((repo_id, repo_type, exist_ok))

    def upload_file(self, path_or_fileobj, path_in_repo, repo_id, repo_type):
        self.files.append((os.path.basename(path_or_fileobj), path_in_repo, repo_id))


@pytest.mark.parametrize("kind,link", [
    ("convnext_atto.d2_in1k", "nabeelr/BTSbot-convnext-pico-in1k-metadata"),
    ("inceptionnext_atto", "nabeelr/BTSbot-inceptionnext-pico-randinit"),
])
def test_publish_uploads_through_an_injected_api(kind, link, tmp_path):
    heads = {"meta_fc1_neurons": 8, "meta_fc2_neurons": 8, "meta_dropout": 0.1,
             "comb_fc1_neurons": 8, "comb_fc2_neurons": 4, "comb_dropout": 0.1,
             "fc1_neurons": 8, "fc2_neurons": 4, "dropout": 0.1, "metadata_cols": META_COLS}
    config = {"model_name": "mm_ConvNeXt", "model_kind": kind, "train_data_version": "vt",
              **heads}
    if "inception" not in kind:
        config = {"model_name": "frozen_fusion", "skip_load_state": True, **heads,
                  "image_model_config": {"model_name": "ConvNeXt", "model_kind": kind, **heads},
                  "meta_model_config": {"model_name": "um_nn", **heads}}
    model = build_model(config, device="cpu")
    run = str(tmp_path)
    torch.save(model.state_dict(), os.path.join(run, BEST_MODEL))
    make_report(config, os.path.join(run, "report.json"), {"run_name": "r"}, {})
    api = StubHfApi()
    assert publish.publish(run, api=api) == link
    assert publish.config_to_params(config) == jax_publish.config_to_params(config)
    assert api.repos == [(link, "model", True)]
    assert [f[1] for f in api.files] == ["pytorch_model.bin", "train_config.json", "README.md"]
    with open(os.path.join(run, "README.md")) as f:
        card = f.read()
    assert ("base_model:" in card) == ("inception" not in kind)
    loaded, _ = load_model_dir(run, device="cpu")
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in loaded.state_dict().items())


def test_export_retargets_a_maxvit_run(tmp_path, monkeypatch, capsys):
    """``--retarget-resolution`` goes through the port's ``maxvit_convert``: the
    bias tables resampled to the new window, the artifact verified at the
    new resolution's graph (a cut MaxViT, as the JAX tests cut it)."""
    from btsbot_tpu_torch.models import maxvit

    monkeypatch.setitem(maxvit.MAXVIT_CONFIGS, "maxvit_tiny",
                        {"depths": (1, 1), "dims": (32, 64), "stem_width": 32})
    config = {"model_name": "MaxViT", "model_kind": "maxvit_tiny_rw_64.test",
              "metadata_cols": META_COLS, "fc1_neurons": 8, "fc2_neurons": 4, "dropout": 0.1,
              "train_data_version": "vt"}
    model = build_model(config, device="cpu")
    run = str(tmp_path)
    torch.save(model.state_dict(), os.path.join(run, BEST_MODEL))
    make_report(config, os.path.join(run, "report.json"), {"run_name": "r"}, {})
    out = export_cli([run, "--retarget-resolution", "96", "--device", "cpu",
                      "--output", os.path.join(run, "m96.onnx")])
    assert "retargeted to maxvit_tiny_rw_96.test" in capsys.readouterr().out
    with open(os.path.join(run, "m96.verification.json")) as f:
        assert json.load(f)["close"]
    from btsbot_tpu_torch.interop.onnx_proto import decode_model
    with open(out, "rb") as f:
        graph = decode_model(f.read())
    sizes = [t.array.tolist() for t in graph.initializers if t.array.tolist() == [3, 96, 96]]
    assert sizes, "the in-graph resize goes to 96 x 96"
    with pytest.raises(ValueError, match="only applies to MaxViT"):
        export_cli([str(_trained_um_nn_dir(tmp_path)), "--retarget-resolution", "96"])


def _trained_um_nn_dir(tmp_path):
    run = tmp_path / "um_nn"
    run.mkdir()
    torch.save(build_model(UM_NN, device="cpu").state_dict(), run / BEST_MODEL)
    make_report(UM_NN, str(run / "report.json"), {"run_name": "r"}, {})
    return run
