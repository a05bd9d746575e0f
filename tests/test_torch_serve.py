"""The port's ingest and scorers against the JAX package's (CPU).

Same weights (flax variables through ``state_dict_from_jax``), same inputs.
Scores in float32 agree within 1e-5; drop masks are identical.
"""

import csv
import gzip
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from btsbot_tpu.engine import serve as jax_serve
from btsbot_tpu.ops.preprocess import preprocess_triplets as jax_preprocess
from btsbot_tpu_torch.data.fits import write_fits_image
from btsbot_tpu_torch.data.synthetic import synthetic_packets
from btsbot_tpu_torch.engine import serve
from btsbot_tpu_torch.interop.weights import state_dict_from_jax
from btsbot_tpu_torch.ops.preprocess import preprocess_triplets
from test_torch_model import atto_config, flax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "btsbot_tpu", "example_data")
META_COLS = [
    "sgscore1", "distpsnr1", "sgscore2", "distpsnr2", "fwhm", "magpsf",
    "sigmapsf", "chipsf", "ra", "dec", "diffmaglim", "ndethist", "nmtchps",
    "age", "days_since_peak", "days_to_peak", "peakmag_so_far", "new_drb",
    "ncovhist", "nnotdet", "chinr", "sharpnr", "scorr", "sky", "maxmag_so_far",
]


def _config():
    return {**atto_config(), "metadata_cols": META_COLS}


def _weights(config, seed=0):
    variables = flax_variables(config, seed)
    return variables, state_dict_from_jax(config, variables)


def _fixtures():
    rng = np.random.default_rng(0)
    t = rng.normal(size=(9, 63, 63, 3)).astype(np.float32)
    t[1, :, :, 0] = np.nan            # all-NaN science cutout: bad median
    t[2, :, :, 1] = 0.0               # all-zero template
    t[3, 5, 5, 0] = np.inf            # a few ±inf pixels: f32 norm overflow
    t[3, 7, 7, 0] = -np.inf
    t[4, 10, 10, 2] = -np.inf
    t[5, :, :, 1] = np.inf            # +inf median
    t[6, :40, :, 2] = np.inf          # +inf and -inf in one cutout
    t[6, 40:, :, 2] = -np.inf
    t[7, 3, 3, 1] = np.nan            # one NaN pixel: cleaned, kept
    t[8] *= 1e-3
    return t


@pytest.mark.parametrize("normalize", [True, False])
def test_preprocess_matches_jax(normalize):
    t = _fixtures()
    want, want_drop = jax_preprocess(jnp.asarray(t), normalize=normalize)
    got, got_drop = preprocess_triplets(torch.from_numpy(t), normalize=normalize)
    np.testing.assert_array_equal(got_drop.numpy(), np.asarray(want_drop))
    assert got_drop.numpy().tolist() == [False, True, True, True, True, True, True,
                                         False, False]
    keep = ~got_drop.numpy()
    np.testing.assert_allclose(got.numpy()[keep], np.asarray(want)[keep],
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("batch_size,buckets", [(3072, None), (256, None), (64, None),
                                                (100, None), (8, [2, 4]),
                                                (512, [1000, 32, 128, 0])])
def test_bucket_ladder_matches_jax(batch_size, buckets):
    assert serve._bucket_ladder(batch_size, buckets) == \
        jax_serve._bucket_ladder(batch_size, buckets, None)


def test_bucket_ladder_default_and_pick():
    ladder = serve._bucket_ladder(3072)
    assert ladder == [192, 768, 3072]
    assert [serve._pick_bucket(ladder, n) for n in (1, 192, 193, 500, 769, 3072)] == \
        [192, 192, 768, 768, 3072, 3072]


def _example():
    trips = np.load(os.path.join(EXAMPLE, "usage_triplets.npy")).astype(np.float32)
    with open(os.path.join(EXAMPLE, "usage_candidates.csv"), newline="") as f:
        meta = np.asarray([[float(r[c]) for c in META_COLS] for r in csv.DictReader(f)],
                          np.float32)
    return trips, meta


@pytest.mark.parametrize("temperature", [1.0, 1.7])
def test_alert_scorer_matches_jax_on_example_alerts(temperature):
    config = _config()
    variables, sd = _weights(config, seed=10)
    trips, meta = _example()
    want = jax_serve.AlertScorer(config, variables, batch_size=8, dtype=jnp.float32,
                                 temperature=temperature)(trips, meta)
    scorer = serve.AlertScorer(config, sd, batch_size=8, dtype=torch.float32,
                               temperature=temperature, device="cpu")
    got = scorer(trips, meta)
    assert got.shape == (len(trips),) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_alert_scorer_partial_batches_pad_to_a_bucket():
    config = _config()
    _, sd = _weights(config, seed=11)
    rng = np.random.default_rng(1)
    trips = rng.normal(size=(11, 63, 63, 3)).astype(np.float32) * 0.01
    meta = rng.normal(size=(11, 25)).astype(np.float32)
    full = serve.AlertScorer(config, sd, batch_size=16, bucket_sizes=[16],
                             dtype=torch.float32, normalize=True, device="cpu")
    bucketed = serve.AlertScorer(config, sd, batch_size=8, bucket_sizes=[2, 4],
                                 dtype=torch.float32, normalize=True, device="cpu")
    assert bucketed.bucket_sizes == [2, 4, 8]
    np.testing.assert_allclose(bucketed(trips, meta), full(trips, meta),
                               rtol=1e-5, atol=1e-6)


def _packets(n, seed):
    packets = list(synthetic_packets(n, META_COLS, seed=seed, unique_stamps=True))
    bad_pixels = np.full((63, 63), np.nan, np.float32)
    packets[2]["cutoutScience"] = {"stampData": gzip.compress(write_fits_image(bad_pixels))}
    packets[5]["cutoutDifference"] = None          # missing cutout
    packets[6]["cutoutTemplate"] = {"stampData": b"not gzip"}
    packets[7]["candidate"] = {"magpsf": "n/a", "sgscore1": float("nan")}
    small = np.ones((50, 40), np.float32)          # undersized stamp: padded
    packets[8]["cutoutScience"] = {"stampData": gzip.compress(write_fits_image(small))}
    return packets


def test_alert_stream_scorer_matches_jax():
    config = _config()
    variables, sd = _weights(config, seed=12)
    packets = _packets(11, seed=3)
    want_s, want_d = jax_serve.AlertStreamScorer(
        config, variables, batch_size=4, dtype=jnp.float32)(packets)
    scorer = serve.AlertStreamScorer(config, sd, batch_size=4, dtype=torch.float32,
                                     device="cpu")
    got_s, got_d = scorer(packets)
    np.testing.assert_array_equal(got_d, want_d)
    assert got_d.tolist() == [i in (2, 5, 6) for i in range(11)]
    assert np.all(np.isnan(got_s[got_d]))
    np.testing.assert_allclose(got_s[~got_d], want_s[~want_d], rtol=0, atol=1e-5)

    chunks = [packets[i:i + 4] for i in range(0, 11, 4)]
    streamed = list(scorer.score_stream(iter(chunks), max_in_flight=3))
    np.testing.assert_array_equal(np.concatenate([s for s, _ in streamed]), got_s)
    with pytest.raises(ValueError, match="exceeds batch_size"):
        list(scorer.score_stream([packets[:5]]))


def test_python_decoder_fallback_matches_native(monkeypatch):
    from btsbot_tpu_torch import native

    packets = _packets(9, seed=5)  # normal, all-NaN, undersized, malformed, empty
    blobs = [packets[i][k]["stampData"] for i in (0, 2, 8)
             for k in ("cutoutScience", "cutoutTemplate")] \
        + [packets[6]["cutoutTemplate"]["stampData"], b""]
    if native.load_library() is None:
        pytest.skip("the native decoder cannot be built on this host")
    want = native.decode_stamps(blobs)
    monkeypatch.setattr(native, "load_library", lambda: None)
    assert native.decoder() == "python"
    got = native.decode_stamps(blobs)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1] != 0, want[1] != 0)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from btsbot_tpu_torch.models.factory import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = _config()
    _, sd = _weights(config)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.AlertScorer(config, sd)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.AlertStreamScorer(config, sd)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(config)


def test_verify_serving_parity_bf16_against_f32():
    config = _config()
    _, sd = _weights(config, seed=13)
    trips, meta = _example()
    out = serve.verify_serving_parity(config, sd, trips[:6], meta[:6], device="cpu")
    assert out["close"] and out["max_diff"] < 0.01
