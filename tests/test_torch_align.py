"""Crop and alignment in the port vs the JAX package: ``crop_and_resize``,
``warp_similarity``, the similarity fits, the OpenFace CSV parse, and
``Mimamo.predict_video`` / ``classify_frames`` / ``crop_video_chunked``
with the same weights, on seeded numpy inputs."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mimamo_tpu import preprocess as jp
from mimamo_tpu.io import openface as jopenface
from mimamo_tpu.runner import Mimamo as JaxMimamo
from mimamo_tpu_torch import preprocess as tp
from mimamo_tpu_torch import weights
from mimamo_tpu_torch.io import openface as topenface
from mimamo_tpu_torch.runner import Mimamo

from test_torch_runner import S, T, _configs

# crops on the 0..255 scale: the port and the JAX package agree to this
PIXEL_ATOL = 1e-3
MATMULS = {"mm", "bmm", "addmm", "baddbmm", "matmul", "dot", "mv"}


class Recorder(TorchDispatchMode):
    """Records every aten op that runs inside, with its arguments, and the
    TF32 switch as it stood when a matmul ran."""

    def __init__(self):
        super().__init__()
        self.ops, self.calls, self.tf32_at_matmul = [], [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.ops.append(name)
        self.calls.append((name, args))
        if name in MATMULS:
            self.tf32_at_matmul.append(
                torch.backends.cuda.matmul.allow_tf32)
        return func(*args, **(kwargs or {}))


def _frames(seed, t=6, h=72, w=96, dtype=np.uint8):
    return np.random.default_rng(seed).integers(
        0, 256, (t, h, w, 3)).astype(dtype)


def _boxes(seed, t=6, h=72, w=96):
    """Boxes that reach past every edge of the frame, and small ones."""
    rng = np.random.default_rng(seed)
    side = rng.uniform(10, 1.2 * h, t)
    return np.stack([rng.uniform(-0.3 * h, h - 5, t),
                     rng.uniform(-0.3 * w, w - 5, t),
                     side, side * rng.uniform(0.8, 1.2, t)],
                    1).astype(np.float32)


def _transforms(seed, t=6, max_deg=30.0):
    """Inverse maps with rotations up to ``max_deg``, scales 0.5-3 and
    offsets that put part of the crop outside the frame."""
    rng = np.random.default_rng(seed)
    th = np.deg2rad(rng.uniform(-max_deg, max_deg, t))
    sc = rng.uniform(0.5, 3.0, t)
    ty, tx = rng.uniform(-30, 70, t), rng.uniform(-30, 90, t)
    return np.stack([
        np.stack([sc * np.cos(th), -sc * np.sin(th), ty], 1),
        np.stack([sc * np.sin(th), sc * np.cos(th), tx], 1)],
        1).astype(np.float32)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("seed", [0, 1])
def test_crop_and_resize_matches_jax(seed, dtype):
    """Boxes past the frame edge, uint8 and float frames: atol 1e-3 on
    0..255 (measured 1.5e-5)."""
    frames, boxes = _frames(seed, dtype=dtype), _boxes(seed)
    want = np.asarray(jp.crop_and_resize(jnp.asarray(frames),
                                         jnp.asarray(boxes), S))
    got = tp.crop_and_resize(torch.from_numpy(frames),
                             torch.from_numpy(boxes), S)
    assert got.dtype == torch.float32 and got.shape == (6, S, S, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=PIXEL_ATOL, rtol=0)


@pytest.fixture
def restore_tf32():
    """Put the TF32 switches back the legacy way after a test that moved
    them (a mix of PyTorch's two APIs would make later reads raise)."""
    prec = torch.get_float32_matmul_precision()
    yield
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision(prec)


def _crop_f64(frames, boxes, out):
    """The crop's two products in float64, from the port's own fp32 hat
    matrices: what is left between it and the crop is the GEMMs'
    precision alone (TF32 would be off by up to ~0.2)."""
    t, h, w, _ = frames.shape
    b = torch.from_numpy(boxes)
    ry = tp._interp_matrix(b[:, 0], b[:, 2], h, out).double().numpy()
    rx = tp._interp_matrix(b[:, 1], b[:, 3], w, out).double().numpy()
    return np.einsum("tqw,tph,thwc->tpqc", rx, ry, frames.astype(np.float64))


@pytest.mark.parametrize("api", ["legacy", "fp32_precision"])
def test_crop_and_resize_is_ieee_under_tf32(restore_tf32, api):
    """With TF32 switched on globally (either API), every matmul of the
    crop runs with it off, the switch is back on afterwards, and the crop
    equals its products taken in float64 to 1e-3 on 0..255."""
    if api == "legacy":
        torch.backends.cuda.matmul.allow_tf32 = True
    else:
        torch.backends.cuda.matmul.fp32_precision = "tf32"
    frames, boxes = _frames(3), _boxes(3)
    rec = Recorder()
    with rec:
        got = tp.crop_and_resize(torch.from_numpy(frames),
                                 torch.from_numpy(boxes), S)
    if api == "legacy":
        assert torch.backends.cuda.matmul.allow_tf32
    else:
        assert torch.backends.cuda.matmul.fp32_precision == "tf32"
    assert len(rec.tf32_at_matmul) == 2
    assert not any(rec.tf32_at_matmul), rec.tf32_at_matmul
    np.testing.assert_allclose(got.numpy(), _crop_f64(frames, boxes, S),
                               atol=PIXEL_ATOL, rtol=0)


def test_crop_and_resize_divides_by_tensors():
    """Every division of the crop has a tensor divisor on its numerator's
    device: CUDA takes a division by a Python number as a product with
    the reciprocal, one ulp off the CPU's true division, and at 720p box
    positions that moved the card's crops by 0.028 on 0..255 from the
    CPU's (H100, ``chip_smoke.py``)."""
    rec = Recorder()
    with rec:
        tp.crop_and_resize(torch.zeros((2, 60, 80, 3)),
                           torch.from_numpy(_boxes(4, t=2)), S)
    divs = [args for name, args in rec.calls if name == "div"]
    assert len(divs) == 2
    for num, den in divs:
        assert isinstance(den, torch.Tensor) and den.device == num.device


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warp_similarity_matches_jax(seed):
    """Rotations up to 30 degrees, scales 0.5-3, crops reaching past the
    frame: atol 1e-3 on 0..255 (measured 0.0: the same fp32 operations in
    the same order)."""
    frames, a = _frames(seed), _transforms(seed)
    want = np.asarray(jp.warp_similarity(jnp.asarray(frames),
                                         jnp.asarray(a), S))
    got = tp.warp_similarity(torch.from_numpy(frames), torch.from_numpy(a),
                             S)
    assert got.dtype == torch.float32 and got.shape == (6, S, S, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=PIXEL_ATOL, rtol=0)


def test_warp_similarity_coordinates_take_no_matmul():
    """The port's form of the JAX package's jaxpr check: no matmul op runs
    anywhere in the warp, so its coordinates stay elementwise fp32 on any
    device and under any TF32 setting; the taps are gathers."""
    rec = Recorder()
    with rec:
        tp.warp_similarity(torch.zeros((2, 60, 80, 3)),
                           torch.zeros((2, 2, 3)), S)
    assert not MATMULS & set(rec.ops), rec.ops
    assert rec.ops.count("gather") == 4


def test_similarity_from_eyes_equal():
    rng = np.random.default_rng(0)
    eyes = rng.uniform(10, 200, (7, 2, 2)).astype(np.float32)
    for kw in ({}, {"eye_y": 0.4, "eye_dx": 0.3}):
        np.testing.assert_array_equal(
            tp.similarity_from_eyes(eyes, 112, **kw),
            jp.similarity_from_eyes(eyes, 112, **kw))


def test_umeyama_fit_equal_and_degenerate_raises():
    rng = np.random.default_rng(1)
    dst, src = rng.normal(size=(10, 2)), rng.normal(size=(10, 2))
    np.testing.assert_array_equal(tp._umeyama_fit(dst, src),
                                  jp._umeyama_fit(dst, src))
    with pytest.raises(ValueError, match="degenerate"):
        tp._umeyama_fit(np.ones((4, 2)), src[:4])


def _landmarks68(seed, t=5):
    """68 points jittered around a face shape that rotates and drifts."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-40, 40, (68, 2))
    th = np.deg2rad(rng.uniform(-20, 20, t))
    rot = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                    np.stack([np.sin(th), np.cos(th)], -1)], -2)
    lm = np.einsum("tij,kj->tki", rot, base) + rng.uniform(60, 120, (t, 1, 2))
    return (lm + rng.normal(0, 0.5, lm.shape)).astype(np.float32)


def test_similarity_from_landmarks_equal():
    """Dense 68-point fits (own template, given template, eye indices)
    and the shape dispatch are exactly equal."""
    lm = _landmarks68(2)
    for kw in ({}, {"template": lm[0]}, {"eye_indices": (3, 40)},
               {"gpa_iters": 1}):
        np.testing.assert_array_equal(
            tp.similarity_from_landmarks68(lm, 112, **kw),
            jp.similarity_from_landmarks68(lm, 112, **kw))
    eyes = lm[:, :2]
    np.testing.assert_array_equal(tp.similarity_from_landmarks(eyes, 64),
                                  jp.similarity_from_landmarks(eyes, 64))
    np.testing.assert_array_equal(tp.similarity_from_landmarks(lm, 64),
                                  jp.similarity_from_landmarks(lm, 64))
    with pytest.raises(ValueError, match=r"\[T, K, 2\]"):
        tp.similarity_from_landmarks(lm[0], 64)
    with pytest.raises(ValueError, match="template shape"):
        tp.similarity_from_landmarks68(lm, 64, template=lm[0, :5])


def test_generic_k_warns_like_jax():
    lm = _landmarks68(3)[:, :10]
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        a = tp.similarity_from_landmarks68(lm, 112)
    with warnings.catch_warnings(record=True) as want:
        warnings.simplefilter("always")
        b = jp.similarity_from_landmarks68(lm, 112)
    np.testing.assert_array_equal(a, b)
    assert [str(w.message) for w in got] == [str(w.message) for w in want]
    assert len(got) == 1 and issubclass(got[0].category, UserWarning)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tp.similarity_from_landmarks68(lm, 112, eye_indices=(0, 9))


def _openface_csv(path, rows):
    hdr = (["frame", " face_id", " timestamp", " confidence", " success"]
           + [f" x_{i}" for i in range(68)] + [f" y_{i}" for i in range(68)])
    with open(path, "w") as f:
        f.write(",".join(hdr) + "\n")
        for r in rows:
            f.write(",".join(str(v) for v in r) + "\n")


def _row(frame, conf, success, lm, face_id=0):
    return ([frame, face_id, frame / 25.0, conf, success]
            + list(lm[:, 1]) + list(lm[:, 0]))


def test_openface_parse_equal(tmp_path):
    """Best face per frame, failed and missing frames held, the frames
    before the first success backfilled, and hold-last padding past the
    end: the parse, the eye centres and the boxes are exactly equal."""
    lm = _landmarks68(4, t=5)
    rows = [_row(1, 0.0, 0, lm[0]), _row(2, 0.9, 1, lm[1]),
            _row(2, 0.95, 1, lm[2], face_id=1), _row(3, 0.2, 0, lm[3]),
            _row(5, 0.8, 1, lm[4])]
    path = str(tmp_path / "v.openface.csv")
    _openface_csv(path, rows)
    for n in (None, 8, 3):
        got = topenface.read_landmarks_csv(path, num_frames=n)
        want = jopenface.read_landmarks_csv(path, num_frames=n)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    dense = got[0]
    np.testing.assert_array_equal(topenface.eyes_from_landmarks68(dense),
                                  jopenface.eyes_from_landmarks68(dense))
    for margin in (0.25, 0.6):
        np.testing.assert_array_equal(
            topenface.boxes_from_landmarks68(dense, 90, 120, margin),
            jopenface.boxes_from_landmarks68(dense, 90, 120, margin))


@pytest.mark.parametrize("body, match", [
    ("a,b,c\n1,2,3\n", "no 'frame' column"),
    ("frame,success\n1,1\n", "missing 2-D landmark column"),
    ("", "empty file"),
])
def test_openface_parse_errors(tmp_path, body, match):
    path = str(tmp_path / "bad.csv")
    with open(path, "w") as f:
        f.write(body)
    with pytest.raises(ValueError, match=match):
        topenface.read_landmarks_csv(path)
    with pytest.raises(ValueError, match=match):
        jopenface.read_landmarks_csv(path)


# -- the runner's video path --------------------------------------------------

VIDEO_T, VIDEO_H, VIDEO_W = 20, 72, 96


@pytest.fixture(scope="module")
def video_case():
    """One source video with drifting boxes and rotated eye points, and the
    JAX references computed once: ``predict_video`` with boxes and with
    landmarks, and ``classify_frames`` of the box crops."""
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (VIDEO_T, VIDEO_H, VIDEO_W, 3),
                          dtype=np.uint8)
    t = np.arange(VIDEO_T)
    side = 50 + 10 * np.sin(t / 4)
    boxes = np.stack([10 + 8 * np.sin(t / 5) - 12 * (t % 7 == 0),
                      20 + t * 1.5, side, side], 1).astype(np.float32)
    th = np.deg2rad(rng.uniform(-15, 15, VIDEO_T))
    cy, cx, half = (boxes[:, 0] + 0.38 * side, boxes[:, 1] + 0.5 * side,
                    0.28 * side)
    eyes = np.stack([np.stack([cy + half * np.sin(th), cx - half * np.cos(th)],
                              -1),
                     np.stack([cy - half * np.sin(th), cx + half * np.cos(th)],
                              -1)], 1).astype(np.float32)
    jcfg, _ = _configs("float32")
    variables = jax.tree_util.tree_map(
        np.asarray, JaxMimamo(jcfg).init_variables(jax.random.PRNGKey(1),
                                                   clip_len=T))
    jm = JaxMimamo(jcfg)
    ref = {"boxes": jm.predict_video(variables, frames, boxes, batch_clips=4),
           "eyes": jm.predict_video(variables, frames, None, batch_clips=4,
                                    landmarks=eyes)}
    crops = jm.crop_video_chunked(frames, boxes)
    ref["probs"] = np.asarray(jm.classify_frames(variables,
                                                 jnp.asarray(crops)[None]))
    model = Mimamo(_configs("float32")[1], device="cpu")
    model.load_state_dict(weights.from_jax_variables(variables))
    return frames, boxes, eyes, model, ref


@pytest.mark.parametrize("mode", ["boxes", "eyes"])
def test_predict_video_matches_jax(video_case, mode):
    """20 frames with drifting boxes (some past the top edge) or rotated
    eye points, 9 windows in batches of 4: f32 atol 1e-3."""
    frames, boxes, eyes, model, ref = video_case
    if mode == "boxes":
        got = model.predict_video(frames, boxes, batch_clips=4)
    else:
        got = model.predict_video(frames, landmarks=eyes, batch_clips=4)
    assert got.shape == (VIDEO_T, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(ref[mode]), atol=1e-3, rtol=0)


def test_classify_frames_matches_jax(video_case):
    """FER+ probabilities [1, T, 8] of the box crops: f32 atol 1e-3, rows
    summing to 1."""
    frames, boxes, _eyes, model, ref = video_case
    crops = model.crop_video_chunked(frames, boxes)
    got = model.classify_frames(crops[None])
    assert got.dtype == torch.float32 and got.shape == (1, VIDEO_T, 8)
    np.testing.assert_allclose(got.numpy(), ref["probs"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("align", [False, True])
def test_crop_video_chunked_tail(video_case, align):
    """Chunks of 6 over 20 frames (a padded tail of 2) give the crops of
    one call over all frames, on the model's device, in float32."""
    frames, boxes, eyes, model, _ref = video_case
    params = (tp.similarity_from_landmarks(eyes, S) if align else boxes)
    whole = model.crop_video_chunked(frames, params, align=align, chunk=64)
    got = model.crop_video_chunked(frames, params, align=align, chunk=6)
    assert got.shape == (VIDEO_T, S, S, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-4,
                               rtol=0)
    with pytest.raises(ValueError, match="empty video"):
        model.crop_video_chunked(frames[:0], params[:0], align=align)


def test_predict_video_needs_boxes_or_landmarks(video_case):
    frames, _boxes, _eyes, model, _ref = video_case
    with pytest.raises(ValueError, match="boxes or landmarks"):
        model.predict_video(frames)
