"""The user API in the port vs the JAX package with the same weights
(``weights.from_jax_variables``): ``MimamoAPI.predict`` (accumulated and
streamed, with emotions, aligned), ``predict_crops``, ``VideoProcessor``,
``FeatureExtractor``, ``smooth_series``, the CSV writer and
``data.crops.CropSource``. The JAX references are computed once per
fixture, at the small config of ``test_torch_runner`` (crops of 32,
backbone input 64, 2 x 2 pyramid, clips of 4 at stride 2)."""

import os
import sys

import jax
import numpy as np
import pytest

from mimamo_tpu import api as japi
from mimamo_tpu.runner import Mimamo as JaxMimamo
from mimamo_tpu_torch import api, weights
from mimamo_tpu_torch.data.crops import CropSource

from test_torch_runner import S, T, _configs

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "bench"))
import tracker_eval  # noqa: E402

ATOL = 1e-3                       # f32 series, probabilities, features
WINDOW = 8                        # decode window / crop chunk: 16 frames = 2
N_FRAMES = 14


@pytest.fixture(scope="module")
def weights_case():
    jcfg, tcfg = _configs("float32")
    variables = jax.tree_util.tree_map(
        np.asarray, JaxMimamo(jcfg).init_variables(jax.random.PRNGKey(2),
                                                   clip_len=T))
    return jcfg, tcfg, variables, weights.from_jax_variables(variables)


def _port_api(weights_case):
    _jcfg, tcfg, _v, state = weights_case
    return api.MimamoAPI(config=tcfg, state_dict=state, device="cpu")


def _read_csv(path):
    with open(path) as f:
        rows = f.read().strip().splitlines()
    return rows[0], np.asarray([[float(v) for v in r.split(",")]
                                for r in rows[1:]])


@pytest.fixture(scope="module")
def video_case(weights_case, tmp_path_factory):
    """A written 14-frame video of a moving rendered face, and the JAX
    API's results on it."""
    pytest.importorskip("cv2")
    jcfg, _tcfg, variables, _state = weights_case
    root = tmp_path_factory.mktemp("video")
    video = str(root / "clip.mp4")
    frames, _gt, _eyes = tracker_eval.render_clip(
        t=N_FRAMES, h=64, w=80, face_size=40, motion="sine", speed=1.5,
        seed=4)
    japi.decode.write_video(video, frames)
    ja = japi.MimamoAPI(config=jcfg, variables=variables)
    ref = {"csv": str(root / "jax.csv")}
    ref["accumulate"] = ja.predict(video, out_csv=ref["csv"],
                                   decode_window=WINDOW)
    ref["stream"] = ja.predict(video, decode_window=WINDOW, emotions=True,
                               streaming_threshold=0)
    ref["align"] = ja.predict(video, decode_window=WINDOW, align=True)
    jvp = japi.VideoProcessor(save_size=S, config=jcfg)
    ref["crops"] = jvp.process(video, str(root / "jax_box"),
                               decode_window=WINDOW)
    ref["aligned"] = jvp.process(video, str(root / "jax_align"), align=True,
                                 decode_window=WINDOW)
    ref["feats"] = np.load(japi.FeatureExtractor(
        config=jcfg, variables=variables, batch_size=4).extract(
        ref["crops"], str(root / "jax.feat.npy")))
    return video, ref


def test_predict_matches_jax(weights_case, video_case, tmp_path):
    """Accumulated windows: the series at f32 atol 1e-3, the same CSV
    header and 1 + T rows."""
    video, ref = video_case
    csv = str(tmp_path / "out.csv")
    got = _port_api(weights_case).predict(video, out_csv=csv,
                                          decode_window=WINDOW)
    assert got.shape == (N_FRAMES, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref["accumulate"], atol=ATOL, rtol=0)
    header, rows = _read_csv(csv)
    want_header, want_rows = _read_csv(ref["csv"])
    assert header == want_header == "frame,valence,arousal"
    assert rows.shape == (N_FRAMES, 3)
    np.testing.assert_allclose(rows, want_rows, atol=ATOL, rtol=0)


def test_predict_streamed_with_emotions_matches_jax(weights_case,
                                                    video_case):
    """``streaming_threshold=0``: every decode window through
    ``predict_stream`` (the tail padded and trimmed), with FER+
    probabilities: both at f32 atol 1e-3; the peak crop count is one
    window."""
    video, ref = video_case
    a = _port_api(weights_case)
    series, probs = a.predict(video, decode_window=WINDOW, emotions=True,
                              streaming_threshold=0)
    np.testing.assert_allclose(series, ref["stream"][0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(probs, ref["stream"][1], atol=ATOL, rtol=0)
    assert probs.shape == (N_FRAMES, 8)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    assert a.last_peak_crop_frames == WINDOW


def test_predict_aligned_matches_jax(weights_case, video_case):
    video, ref = video_case
    got = _port_api(weights_case).predict(video, decode_window=WINDOW,
                                          align=True)
    np.testing.assert_allclose(got, ref["align"], atol=ATOL, rtol=0)


@pytest.mark.parametrize("align", [False, True])
def test_video_processor_matches_jax(weights_case, video_case, tmp_path,
                                     align):
    """uint8 crops within 1 LSB of the JAX package's, the same boxes and
    (aligned) landmarks files."""
    video, ref = video_case
    want = ref["aligned" if align else "crops"]
    vp = api.VideoProcessor(save_size=S, config=weights_case[1],
                            device="cpu")
    out = vp.process(video, str(tmp_path / "w"), align=align,
                     decode_window=WINDOW)
    assert os.path.basename(out) == "clip.npy"
    got = np.load(out)
    assert got.dtype == np.uint8 and got.shape == (N_FRAMES, S, S, 3)
    assert np.abs(got.astype(int) - np.load(want).astype(int)).max() <= 1
    for suffix in (".boxes.npy",) + ((".landmarks.npy",) if align else ()):
        np.testing.assert_array_equal(
            np.load(out.replace(".npy", suffix)),
            np.load(want.replace(".npy", suffix)))


def test_feature_extractor_matches_jax(weights_case, video_case, tmp_path):
    """Batches of 4 over 14 crops (a padded tail): the ``.feat.npy``
    equals the JAX package's at f32 atol 1e-3, and next to the crops by
    default."""
    _video, ref = video_case
    crops = str(tmp_path / "c.npy")
    np.save(crops, np.load(ref["crops"]))
    fx = api.FeatureExtractor(config=weights_case[1],
                              state_dict=weights_case[3], batch_size=4,
                              device="cpu")
    out = fx.extract(crops)
    assert out == str(tmp_path / "c.feat.npy")
    got = np.load(out)
    assert got.shape == (N_FRAMES, 2048) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref["feats"], atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def crops_case(weights_case, tmp_path_factory):
    """A packed ``.npy`` of 19 seeded uint8 crops and the JAX API's
    ``predict_crops`` on it (accumulated; streamed with emotions)."""
    jcfg, _tcfg, variables, _state = weights_case
    path = str(tmp_path_factory.mktemp("crops") / "c.npy")
    np.save(path, np.random.default_rng(6).integers(
        0, 256, (19, S, S, 3), dtype=np.uint8))
    ja = japi.MimamoAPI(config=jcfg, variables=variables)
    return path, {
        "accumulate": ja.predict_crops(path, chunk=WINDOW),
        "stream": ja.predict_crops(path, chunk=WINDOW, emotions=True,
                                   streaming_threshold=0),
        "smoothed": ja.predict_crops(path, chunk=WINDOW, smooth=3,
                                     max_frames=11)}


def test_predict_crops_matches_jax(weights_case, crops_case, tmp_path):
    path, ref = crops_case
    a = _port_api(weights_case)
    np.testing.assert_allclose(a.predict_crops(path, chunk=WINDOW),
                               ref["accumulate"], atol=ATOL, rtol=0)
    assert a.last_peak_crop_frames == 19
    series, probs = a.predict_crops(path, chunk=WINDOW, emotions=True,
                                    streaming_threshold=0)
    np.testing.assert_allclose(series, ref["stream"][0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(probs, ref["stream"][1], atol=ATOL, rtol=0)
    got = a.predict_crops(path, chunk=WINDOW, smooth=3, max_frames=11)
    assert got.shape == (11, 2)
    np.testing.assert_allclose(got, ref["smoothed"], atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="must be odd"):
        a.predict_crops(path, smooth=2)


def test_smooth_series_and_csv_text_equal(tmp_path):
    """The same moving average, and byte-identical CSVs (header, %.6f
    series, %.4f probabilities) for the same arrays."""
    rng = np.random.default_rng(8)
    series = rng.normal(size=(12, 2)).astype(np.float32)
    probs = rng.dirichlet(np.ones(8), 12).astype(np.float32)
    for window in (1, 3, 5):
        np.testing.assert_array_equal(api.smooth_series(series, window),
                                      japi.smooth_series(series, window))
    with pytest.raises(ValueError, match="must be odd"):
        api.smooth_series(series, 4)
    for p in (None, probs):
        got, want = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
        api._write_csv(got, series, p)
        japi._write_csv(want, series, p)
        with open(got) as f, open(want) as g:
            assert f.read() == g.read()


def test_checkpoint_dir_is_not_ported(weights_case):
    with pytest.raises(NotImplementedError, match="A11"):
        api.MimamoAPI(config=weights_case[1], device="cpu",
                      checkpoint_dir="/nonexistent")


def test_crop_source(tmp_path):
    """A packed ``.npy`` with a length check, the config's crop size
    enforced, and an image directory read like the array."""
    crops = np.random.default_rng(9).integers(0, 256, (5, S, S, 3),
                                              dtype=np.uint8)
    path = str(tmp_path / "c.npy")
    np.save(path, crops)
    src = CropSource(path, crop_size=S)
    assert len(src) == 5
    np.testing.assert_array_equal(src.read(1, 3), crops[1:4])
    np.testing.assert_array_equal(src.read_all(), crops)
    with pytest.raises(ValueError, match="config expects"):
        CropSource(path, crop_size=S + 8)
    with pytest.raises(FileNotFoundError):
        CropSource(str(tmp_path / "missing.npy"))
    np.save(path, crops[:3])
    with pytest.raises(RuntimeError, match="changed length"):
        src.read(0, 2)
    cv2 = pytest.importorskip("cv2")
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i, c in enumerate(crops[:3]):
        cv2.imwrite(str(img_dir / f"{i}.png"), c[..., ::-1])
    np.testing.assert_array_equal(CropSource(str(img_dir)).read_all(),
                                  crops[:3])
