"""The port's data layer against the JAX package on the same inputs.

Ingest (``center_crop`` / ``crop_triplets`` / ``nan_row_mask`` and
``make_triplet``, both computing in float32: 1e-6), the candidate table
(``engineered_features`` / ``prep_alerts``: columns equal, NaN-aware), the
split engine (``assign_splits``, ``merge_sets``, ``create_subset``,
``subsample_objects``, ``build_dataset_files``: triplets bit-equal, candidate
CSVs byte-equal and read back equal by both readers), the HF dataset, and
the clients: ``query_alerts`` / ``download_training_data`` through a fake
Kowalski client (raw cache, a corrupt stamp), the ztfid and cutouts functions
on stub sessions.  Nothing touches the network.

Fixtures hold objects out of sorted order and alerts with equal jd, so the
first-appearance object order and the tie order of "latest by jd" are
exercised.
"""

import base64
import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from btsbot_tpu.data import alerts as jax_alerts
from btsbot_tpu.data import splits as jax_splits
from btsbot_tpu.data.query import kowalski as jax_kowalski
from btsbot_tpu.data.query import ztfid as jax_ztfid
from btsbot_tpu.ops import preprocess as jax_pre
from btsbot_tpu_torch.data import alerts, splits
from btsbot_tpu_torch.data.dataset import read_candidates, sort_order, write_candidates
from btsbot_tpu_torch.data.query import cutouts, kowalski, ztfid
from btsbot_tpu_torch.ops import preprocess

import torch_stub_sessions as stubs


def _table(df: pd.DataFrame) -> dict:
    return {k: df[k].to_numpy() for k in df.columns}


def _assert_tables_equal(got: dict, want: pd.DataFrame):
    assert list(got) == list(want.columns)
    for k in want.columns:
        w, g = want[k].to_numpy(), np.asarray(got[k])
        if w.dtype.kind == "f" or g.dtype.kind == "f":
            np.testing.assert_array_equal(g.astype(np.float64), w.astype(np.float64),
                                          err_msg=k)
        else:
            assert [str(x) for x in g.tolist()] == [str(x) for x in w.tolist()], k


def _assert_csv_equal(path_got: str, path_want: str):
    with open(path_got) as a, open(path_want) as b:
        assert a.read() == b.read()
    for reader in (read_candidates, lambda p: _table(pd.read_csv(p))):
        x, y = reader(path_got), reader(path_want)
        assert list(x) == list(y)
        for k in x:
            if x[k].dtype == object:   # strings with NaN for an empty field
                assert [str(v) for v in x[k]] == [str(v) for v in y[k]], k
            else:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)


# ------------------------------- ingest ---------------------------------

@pytest.mark.parametrize("size", [63, 47, 31])
def test_crop_and_nan_rows_match_jax(size):
    rng = np.random.default_rng(size)
    trips = rng.normal(size=(5, 63, 63, 3)).astype(np.float32)
    trips[2, 10, 20, 1] = np.nan
    t = torch.from_numpy(trips)
    np.testing.assert_array_equal(preprocess.center_crop(t, size).numpy(),
                                  np.asarray(jax_pre.center_crop(jnp.asarray(trips), size)))
    clean = np.nan_to_num(trips)
    np.testing.assert_allclose(
        preprocess.crop_triplets(torch.from_numpy(clean), size).numpy(),
        np.asarray(jax_pre.crop_triplets(jnp.asarray(clean), size)), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(preprocess.nan_row_mask(t).numpy(),
                                  np.asarray(jax_pre.nan_row_mask(jnp.asarray(trips))))


@pytest.mark.parametrize("form", ["bytes", "bson_dict", "bson_str", "undersized", "corrupt"])
def test_make_triplet_matches_jax(form):
    p = stubs.alert_packet(7, size=60 if form == "undersized" else 63)
    if form.startswith("bson"):
        b64 = base64.b64encode(p["cutoutScience"]["stampData"]).decode()
        p["cutoutScience"]["stampData"] = {"$binary": {"base64": b64, "subType": "00"}
                                           if form == "bson_dict" else b64}
    if form == "corrupt":
        p["cutoutTemplate"] = {"stampData": stubs.stamp_blob(np.zeros((63, 63)))}
    got, drop = alerts.make_triplet(p, device="cpu")
    want, want_drop = jax_alerts.make_triplet(p)
    assert got.dtype == want.dtype == np.float64 and drop == want_drop == (form == "corrupt")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(alerts.triplet_from_packet(p),
                                  jax_alerts.triplet_from_packet(p))


def test_plot_triplet_matches_jax():
    import matplotlib
    import matplotlib.pyplot as plt

    matplotlib.use("Agg")
    trip = np.abs(alerts.make_triplet(stubs.alert_packet(3), device="cpu")[0]) + 1e-3
    figs = [alerts.plot_triplet(trip), jax_alerts.plot_triplet(trip)]
    try:
        got, want = ([(ax.get_title(), np.asarray(ax.images[0].get_array()),
                       type(ax.images[0].norm).__name__) for ax in f.axes] for f in figs)
    finally:
        for f in figs:
            plt.close(f)
    assert [g[0] for g in got] == [w[0] for w in want] == ["Science", "Reference", "Difference"]
    assert [g[2] for g in got] == [w[2] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[1], w[1])


def _alert_frame(n_obj=12, seed=0):
    """Alerts of objects in shuffled order, jd ties and repeated magnitudes."""
    rng = np.random.default_rng(seed)
    rows = []
    for o in rng.permutation(n_obj):
        for _ in range(int(rng.integers(1, 7))):
            rows.append({"objectId": f"ZTF{o:04d}", "jd": 2459000.0 + int(rng.integers(0, 4)),
                         "magpsf": round(float(rng.uniform(17, 20)), 1),
                         "jdstarthist": 2458990.0 + int(rng.integers(0, 15)),
                         "ncovhist": int(rng.integers(5, 30)),
                         "ndethist": int(rng.integers(0, 5))})
    return pd.DataFrame(rows)


def test_engineered_features_match_jax():
    df = _alert_frame()
    _assert_tables_equal(alerts.engineered_features(_table(df)),
                         jax_alerts.engineered_features(df))


def _alert_packets(seed=0, n_obj=6):
    """Packets of several objects (out of order, with jd ties), no cutouts;
    some lack a classification, one field is None in some, one int field is
    missing in some (pandas types those columns object / float64)."""
    rng = np.random.default_rng(seed)
    out = []
    for o in rng.permutation(n_obj):
        for i in range(int(rng.integers(1, 5))):
            cand = {**stubs.CANDIDATE, "candid": len(out),
                    "jd": 2459100.0 + int(rng.integers(0, 3)),
                    "magpsf": round(float(rng.uniform(17, 20)), 2),
                    "fid": int(rng.integers(1, 4)), "jdstarthist": 2459090.5,
                    "ssdistnr": None if i % 2 else float(rng.uniform(0, 5)),
                    "ssnamenr": None if i % 3 else f"{o}P"}
            if len(out) % 4 == 1:
                del cand["sigmapsf"], cand["ndethist"]
            packet = {"objectId": f"ZTF22{o:04d}", "candidate": cand}
            if len(out) % 5:
                packet["classifications"] = {"acai_h": float(rng.uniform())}
            out.append(packet)
    return out


def _nondet(objid, jd):
    return (np.nan, np.nan) if objid.endswith("1") else (jd - 1.5, 20.0 + jd % 1)


@pytest.mark.parametrize("label", ["int", "list", "none"])
def test_prep_alerts_matches_jax(label, tmp_path):
    packets = _alert_packets()
    lab = {"int": 1, "list": list(np.arange(len(packets)) % 2), "none": None}[label]
    drb = np.linspace(0, 1, len(packets))
    got = alerts.prep_alerts(packets, lab, new_drb=drb, nondet_fn=_nondet)
    want = jax_alerts.prep_alerts(packets, lab, new_drb=drb, nondet_fn=_nondet)
    _assert_tables_equal(got, want)
    write_candidates(got, str(tmp_path / "got.csv"))
    want.to_csv(tmp_path / "want.csv", index=False)
    _assert_csv_equal(str(tmp_path / "got.csv"), str(tmp_path / "want.csv"))


# -------------------------------- splits --------------------------------

def _set_frame(n_obj=30, seed=0, ties=False):
    """A source set: objects out of sorted order, triplets that mark their
    row, optionally alerts with equal jd (at the "latest" cut)."""
    rng = np.random.default_rng(seed)
    rows, trips = [], []
    for o in rng.permutation(n_obj):
        n = int(rng.integers(2, 8))
        peak = rng.uniform(17, 20)
        for i in range(n):
            rows.append({
                "objectId": f"ZTF{o:04d}",
                "jd": 2459000.0 + o + (i // 2 if ties else i),
                "magpsf": peak + abs(rng.normal(0, 0.7)) * (i > 0),
                "peakmag": peak,
                "isdiffpos": "t" if rng.random() < 0.9 else "f",
                "fid": int(rng.integers(1, 4)),
                "sgscore1": rng.uniform(-1, 1),
                "sgscore2": rng.uniform(-1, 1),
                "label": int(peak < 18.5),
            })
            trips.append(np.full((4, 4, 3), len(rows), dtype=np.float32))
    return np.stack(trips), pd.DataFrame(rows)


_DIMS_TYPES = pd.DataFrame({"ZTFID": [f"ZTF{o:04d}" for o in range(0, 30, 3)],
                            "type": ["SN Ia", "AGN", "CV", "SN II", "varstar"] * 2})


@pytest.mark.parametrize("set_name,cuts", [("trues", "only_pd_gr"), ("dims", "only_pd_gr_ps"),
                                           ("vars", None)])
def test_assign_splits_matches_jax(set_name, cuts):
    trips, df = _set_frame(seed=len(set_name), ties=True)
    kw = {"dims_types": _DIMS_TYPES} if set_name == "dims" else {}
    jt, jc = jax_splits.assign_splits(trips, df, set_name, seed=2,
                                      cuts=cuts and getattr(jax_splits, cuts), **kw)
    if kw:
        kw = {"dims_types": _table(_DIMS_TYPES)}
    t, c = splits.assign_splits(trips, _table(df), set_name, seed=2,
                                cuts=cuts and getattr(splits, cuts), **kw)
    np.testing.assert_array_equal(t, jt)
    _assert_tables_equal(c, jc)


def _assigned(seed, set_name="vars"):
    trips, df = _set_frame(seed=seed, ties=True)
    jt, jc = jax_splits.assign_splits(trips, df, set_name, seed=2)
    return (jt, jc), splits.assign_splits(trips, _table(df), set_name, seed=2)


@pytest.mark.parametrize("split,caps", [("train", (3, 3)), ("train", (2, 4)), ("val", (3, 0)),
                                        ("test", (2, 2))])
@pytest.mark.parametrize("set_name", ["vars", "trues", "dims"])
def test_create_subset_matches_jax(set_name, split, caps):
    (jt, jc), (t, c) = _assigned(4, set_name)
    for flags in ({}, {"sne_only": True, "keep_near_threshold": False, "rise_only": True}):
        want = jax_splits.create_subset(jt, jc, split, *caps, **flags)
        got = splits.create_subset(t, c, split, *caps, **flags)
        np.testing.assert_array_equal(got[0], want[0])
        _assert_tables_equal(got[1], want[1])
        assert got[2] == want[2]


@pytest.mark.parametrize("ascending", [True, False])
def test_sort_order_is_pandas_sort_values(ascending):
    """Ties and NaNs fall as in pandas' ``sort_values`` (numpy's quicksort on
    the non-NaN values, NaN last): "latest by jd" keeps the JAX package's
    alerts where equal jd straddle the cut."""
    rng = np.random.default_rng(1)
    for n in (5, 17, 40, 300):
        jd = rng.integers(0, max(2, n // 4), n).astype(np.float64)
        jd[rng.random(n) < 0.1] = np.nan
        want = pd.Series(jd).sort_values(ascending=ascending).index.to_numpy()
        np.testing.assert_array_equal(sort_order(jd, ascending), want)


def test_merge_of_tables_with_other_columns_matches_jax():
    _, a = _set_frame(n_obj=4, seed=7)
    b = a.drop(columns=["fid", "isdiffpos"]).assign(extra=1.5, flag=True)
    parts = [(np.arange(len(a)), a), (np.arange(len(b)) + 100, b)]
    wt, wc = jax_splits.merge_sets(parts, seed=2)
    gt, gc = splits.merge_sets([(t, _table(c)) for t, c in parts], seed=2)
    np.testing.assert_array_equal(gt, wt)
    _assert_tables_equal(gc, wc)


def test_merge_and_subsample_match_jax():
    (jt, jc), (t, c) = _assigned(5)
    (jt2, jc2), (t2, c2) = _assigned(6, "trues")
    wt, wc = jax_splits.merge_sets([(jt, jc), (jt2, jc2)], seed=3)
    gt, gc = splits.merge_sets([(t, c), (t2, c2)], seed=3)
    np.testing.assert_array_equal(gt, wt)
    _assert_tables_equal(gc, wc)
    for perc in (10, 50):
        want = jax_splits.subsample_objects(wt, wc, perc, seed=2)
        got = splits.subsample_objects(gt, gc, perc, seed=2)
        np.testing.assert_array_equal(got[0], want[0])
        _assert_tables_equal(got[1], want[1])


def _write_base_set(base, name, seed):
    trips, df = _set_frame(n_obj=40, seed=seed, ties=True)
    trips = np.random.default_rng(seed).normal(size=(len(df), 4, 4, 3))
    np.save(os.path.join(base, f"{name}_triplets.npy"), trips)
    df.to_csv(os.path.join(base, f"{name}_candidates.csv"), index=False)


def test_read_candidates_parses_floats_exactly(tmp_path):
    """The port reads every float a CSV holds back to the value written
    (shortest repr); pandas' default C parser rounds some 17-digit values one
    ulp off, its round-trip parser does not."""
    values = np.random.default_rng(0).uniform(17, 20, 2000)
    values[:2] = [18.299999999999997, 19.099999999999998]
    write_candidates({"x": values}, str(tmp_path / "x.csv"))
    np.testing.assert_array_equal(read_candidates(str(tmp_path / "x.csv"))["x"], values)
    np.testing.assert_array_equal(
        pd.read_csv(tmp_path / "x.csv", float_precision="round_trip")["x"].to_numpy(), values)


def test_build_dataset_files_matches_jax(tmp_path, monkeypatch):
    base = tmp_path / "base"
    base.mkdir()
    for i, name in enumerate(("trues", "dims", "vars", "rejects")):
        _write_base_set(str(base), name, seed=10 + i)
    _DIMS_TYPES.to_csv(base / "dims.csv", index=False)
    sets = ["trues", "dims", "vars", "rejects"]
    # the JAX package reads the base CSVs with pandas; its round-trip parser
    # reads the values the port reads (the default one rounds some one ulp
    # off: test above).  Seed 3 puts 3 of each set's 40 objects in val and 3
    # in test.
    read_csv = pd.read_csv
    monkeypatch.setattr(pd, "read_csv",
                        lambda *a, **k: read_csv(*a, float_precision="round_trip", **k))
    jax_splits.build_dataset_files(str(base), str(tmp_path / "jax"), sets, "vt", seed=3,
                                   N_max_p=3, N_max_n=2)
    splits.build_dataset_files(str(base), str(tmp_path / "torch"), sets, "vt", seed=3,
                               N_max_p=3, N_max_n=2)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch")) and len(names) == 12
    for name in names:
        got, want = str(tmp_path / "torch" / name), str(tmp_path / "jax" / name)
        if name.endswith(".npy"):
            a, b = np.load(got), np.load(want)
            assert a.dtype == b.dtype and len(a)
            np.testing.assert_array_equal(a, b)
        else:
            _assert_csv_equal(got, want)


def test_hf_dataset_matches_jax():
    from btsbot_tpu.data.hf_dataset import dataset_from_arrays as jax_ds
    from btsbot_tpu_torch.data.hf_dataset import dataset_from_arrays

    _, df = _set_frame(n_obj=3, seed=6)
    df = df.assign(candid=np.arange(len(df)) + 10**12, is_SN=df["label"] > 0)
    trips = np.random.default_rng(0).normal(size=(len(df), 63, 63, 3)).astype(np.float32)
    got, want = dataset_from_arrays(trips, _table(df)), jax_ds(trips, df)
    assert got.features == want.features
    assert got.to_dict() == want.to_dict()


# ------------------------------- clients --------------------------------

def _object_packets(n_obj=4, seed=0):
    out = {}
    for o in range(n_obj):
        oid = f"ZTF23{o:04d}"
        plist = []
        for i in range(3):
            p = stubs.alert_packet(seed + 10 * o + i, objid=oid, programid=1 + (i % 2),
                        candid=10 * o + i, jd=2459300.5 + i, magpsf=18.0 + 0.4 * o - 0.1 * i,
                        jdstarthist=2459290.0)
            plist.append(p)
        out[oid] = plist
    out["ZTF230001"][0]["cutoutDifference"] = {"stampData": stubs.stamp_blob(np.full((63, 63), np.nan))}
    return out


PRV = {"ZTF230000": [{"jd": 2459299.0, "diffmaglim": 20.1},
                     {"jd": 2459299.5, "diffmaglim": 20.4, "magpsf": None},
                     {"jd": 2459299.5, "diffmaglim": 20.7},
                     {"jd": 2459301.0, "diffmaglim": 21.0}],
       "ZTF230002": [{"jd": 2459200.0, "magpsf": 19.0, "diffmaglim": 20.0}]}


@pytest.mark.parametrize("objid", ["ZTF230000", "ZTF230002", "ZTF230003"])
def test_query_nondet_matches_jax(objid):
    client = stubs.FakeKowalski({}, PRV)
    got = kowalski.query_nondet(client, objid, 2459300.5)
    want = jax_kowalski.query_nondet(client, objid, 2459300.5)
    np.testing.assert_array_equal(np.asarray(got, np.float64), np.asarray(want, np.float64))


def test_query_alerts_cache_and_corrupt_stamp_match_jax(tmp_path):
    packets = _object_packets()
    client = stubs.FakeKowalski(packets)
    ids = list(packets)[::-1]
    got = kowalski.query_alerts(ids, client, 1, save_raw=str(tmp_path), device="cpu")
    want = jax_kowalski.query_alerts(ids, stubs.FakeKowalski(packets), 1)
    assert len(got) == len(want) == 7  # 8 programid-1 alerts, one corrupt
    for g, w in zip(got, want):
        assert g["candidate"] == w["candidate"] and g["triplet"].dtype == np.float64
        np.testing.assert_allclose(g["triplet"], w["triplet"], rtol=1e-6, atol=1e-6)
    calls = client.calls
    cached = kowalski.query_alerts(ids, client, 1, load_raw=str(tmp_path), device="cpu")
    assert client.calls == calls and len(os.listdir(tmp_path)) == 4
    for g, c in zip(got, cached):
        np.testing.assert_array_equal(g["triplet"], c["triplet"])


@pytest.mark.parametrize("cutout_size", [63, 47])
def test_download_training_data_matches_jax(cutout_size, tmp_path):
    packets = _object_packets(seed=3)
    query = pd.DataFrame({"ZTFID": list(packets)})

    def drb(trips):
        return np.linspace(0.0, 1.0, len(trips))

    for pkg, frame, out in ((kowalski, _table(query), "torch"), (jax_kowalski, query, "jax")):
        kw = {"device": "cpu"} if pkg is kowalski else {}
        pkg.download_training_data(frame, "trues", "compute", client=stubs.FakeKowalski(packets, PRV),
                                   out_dir=str(tmp_path / out), cutout_size=cutout_size,
                                   drb_fn=drb, **kw)
    suffix = "" if cutout_size == 63 else str(cutout_size)
    got = np.load(tmp_path / "torch" / f"trues_triplets{suffix}.npy")
    want = np.load(tmp_path / "jax" / f"trues_triplets{suffix}.npy")
    assert got.dtype == want.dtype and got.shape == want.shape == (11, cutout_size,
                                                                   cutout_size, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    _assert_csv_equal(str(tmp_path / "torch" / "trues_candidates.csv"),
                      str(tmp_path / "jax" / "trues_candidates.csv"))
    g = read_candidates(str(tmp_path / "torch" / "trues_candidates.csv"))
    assert set(g["label"]) == {0, 1} and np.isfinite(g["last_nondet_jd"]).sum() == 3


def test_ztfid_source_lists_match_jax(tmp_path, monkeypatch):
    monkeypatch.setattr("time.sleep", lambda _s: None)
    for pkg, out in ((ztfid, "torch"), (jax_ztfid, "jax")):
        pkg.compile_ztfids(str(tmp_path / out), session=stubs.FritzSession())
    for name in ("trues", "vars", "dims", "rejects"):
        _assert_csv_equal(str(tmp_path / "torch" / f"{name}.csv"),
                          str(tmp_path / "jax" / f"{name}.csv"))
    trues = read_candidates(str(tmp_path / "torch" / "trues.csv"))
    assert not set(trues["ZTFID"]) & set(ztfid.OBJS_TO_REMOVE)
    assert (trues["RCF_save_time"] > 2.4e6).sum() == 2
    for pkg in (ztfid, jax_ztfid):
        assert pkg.query_rejects(session=stubs.FritzSession(page=3), sleep=0) == \
            [f"ZTF21rej{i:04d}" for i in range(7)] + ["ZTF21aaa"]
    path = tmp_path / "ext.csv"
    pd.DataFrame({"ztfname": ["ZTF20aaa", "SN2020x", "ZTF20bbb"], "z": [0.1, 0.2, 0.3]}
                 ).to_csv(path, index=False)
    ids = np.array(["ZTF20bbb"], dtype=object)
    got, got_ids = ztfid.load_external_ias(str(path), ids)
    want, want_ids = jax_ztfid.load_external_ias(str(path), ids)
    _assert_tables_equal(got, want.reset_index(drop=True))
    np.testing.assert_array_equal(got_ids, want_ids)
    assert ztfid.iso_to_jd("2021-01-01T00:00:00Z") == jax_ztfid.iso_to_jd("2021-01-01T00:00:00")


def test_cutout_fetchers_match_jax():
    from btsbot_tpu.data.query import cutouts as jax_cutouts

    session = stubs.SurveySession()
    assert cutouts.get_ps_url(10.0, 20.0, session=session) == \
        jax_cutouts.get_ps_url(10.0, 20.0, session=session)
    for fetch in ("fetch_ls_image", "fetch_ps_image"):
        got, got_empty = getattr(cutouts, fetch)(10.0, 20.0, session=session)
        want, want_empty = getattr(jax_cutouts, fetch)(10.0, 20.0, session=session)
        assert got.dtype == want.dtype and got_empty == want_empty
        np.testing.assert_array_equal(got, want)
    assert cutouts.get_ps_url(1.0, 2.0, session=stubs.SurveySession(bands="gr")) is None


def test_process_dataset_offline(tmp_path):
    """The spawned pool with a stub session: one object's download fails and
    one has no coverage, so both leave the "nd" variant."""
    rows = {"objectId": np.array(["ZTFa", "ZTFb", "ZTFa", "ZTFfail", "ZTFempty"]),
            "ra": np.array([1.0, 2.0, 1.0, 3.0, 4.0]), "dec": np.array([5.0, 6.0, 5.0, 7.0, 8.0]),
            "label": np.array([1, 0, 1, 0, 0])}
    write_candidates(rows, str(tmp_path / "train_cand_vt_N100.csv"))
    cutouts.process_dataset("LS", "train", "vt", workers=2, data_dir=str(tmp_path),
                            session=stubs.SurveySession())
    cand = read_candidates(str(tmp_path / "train_cand_vtLS63_N100.csv"))
    imgs = np.load(tmp_path / "train_triplets_vtLS63_N100.npy")
    np.testing.assert_array_equal(cand["missing_LS"], [False, False, False, True, True])
    assert imgs.shape == (5, 63, 63, 3) and imgs.dtype == np.float16
    np.testing.assert_array_equal(imgs[0], imgs[2])
    assert not imgs[3].any()
    nd = read_candidates(str(tmp_path / "train_cand_vtLS63nd_N100.csv"))
    assert nd["objectId"].tolist() == ["ZTFa", "ZTFb", "ZTFa"]
    assert np.load(tmp_path / "train_triplets_vtLS63nd_N100.npy").shape[0] == 3
