"""Host-side input in the port vs the JAX package: the box and eye
trackers, ``WindowParams``, the sidecar and image-dir helpers, windowed
decode and the native Haar loader, on a seeded synthetic moving face.
Everything here is numpy/OpenCV on both sides, so it must be exactly
equal."""

import os
import sys

import numpy as np
import pytest

from mimamo_tpu.io import decode as jdecode
from mimamo_tpu.io import native_loader as jnative
from mimamo_tpu_torch.io import decode as tdecode
from mimamo_tpu_torch.io import native_loader as tnative

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "bench"))
import tracker_eval  # noqa: E402

CROP = 32


@pytest.fixture(scope="module")
def clip():
    """23 frames of a rendered face moving on a sine path: frames, gt
    boxes, gt eyes."""
    pytest.importorskip("cv2")
    return tracker_eval.render_clip(t=23, h=96, w=128, face_size=48,
                                    motion="sine", speed=2.0, seed=3)


class FakeFaceDet:
    """Detections in cv2's (x, y, w, h), a given list per call; an empty
    list is a miss."""

    def __init__(self, gt):
        self.calls = 0
        self.gt = gt

    def detectMultiScale(self, gray, *args, **kwargs):  # noqa: N802
        i, self.calls = self.calls, self.calls + 1
        if i % 3 == 2:
            return []
        y, x, h, w = self.gt[min(8 * i, len(self.gt) - 1)]
        return [(int(x) + 2, int(y) - 1, int(w) - 3, int(h)),
                (1, 1, 8, 8)]


class FakeEyeDet:
    """An eyebrow band and two eyes, relative to the ROI; every third call
    finds one rect only."""

    def __init__(self):
        self.calls = 0

    def detectMultiScale(self, roi, *args, **kwargs):  # noqa: N802
        i, self.calls = self.calls, self.calls + 1
        h, w = roi.shape[:2]
        rects = [(w // 8, h // 10, 3 * w // 4, h // 8),
                 (w // 6 + i % 2, h // 2, w // 5, h // 6),
                 (3 * w // 5, h // 2 + i % 3, w // 5, h // 6)]
        return rects[:1] if i % 3 == 1 else rects


def _trackers(mod, clip, track, detect):
    frames, gt, gt_eyes = clip
    bt = mod.BoxTracker(frames.shape[1], frames.shape[2], detect_every=4,
                        track=track)
    et = mod.EyeTracker(detect_every=5, track=track)
    bt.det = FakeFaceDet(gt) if detect else None
    et.det = FakeEyeDet() if detect else None
    if not detect:
        bt.last = gt[0].copy()
        et.last = gt_eyes[0].copy()
    return bt, et


@pytest.mark.parametrize("detect", [True, False])
@pytest.mark.parametrize("track", ["lk", "hold"])
def test_trackers_equal(clip, track, detect):
    """BoxTracker and EyeTracker frame by frame, with mocked detections
    (the Haar cascades do not fire on rendered faces) or from the first
    frame's truth, and the fused ``track_boxes_and_eyes``: exactly
    equal."""
    frames = clip[0]
    got, want = (_trackers(m, clip, track, detect)
                 for m in (tdecode, jdecode))
    for f in frames:
        b, bj = got[0].update(f), want[0].update(f)
        np.testing.assert_array_equal(b, bj)
        np.testing.assert_array_equal(got[1].update(f, b),
                                      want[1].update(f, bj))
    got, want = (_trackers(m, clip, track, detect)
                 for m in (tdecode, jdecode))
    for a, b in zip(tdecode.track_boxes_and_eyes(frames, *got),
                    jdecode.track_boxes_and_eyes(frames, *want)):
        np.testing.assert_array_equal(a, b)


def test_array_wrappers_equal(clip):
    """``face_boxes`` and ``eye_landmarks`` with the detectors this machine
    has (the same for both packages)."""
    frames = clip[0]
    boxes = tdecode.face_boxes(frames)
    np.testing.assert_array_equal(boxes, jdecode.face_boxes(frames))
    for track in ("lk", "hold"):
        np.testing.assert_array_equal(
            tdecode.eye_landmarks(frames, boxes, track=track),
            jdecode.eye_landmarks(frames, boxes, track=track))
    with pytest.raises(ValueError, match="track must be"):
        tdecode.BoxTracker(8, 8, track="flow")


def _sidecars(tmp_path, kind, clip):
    """A video path and its sidecar of ``kind``; the video file itself is
    never read by ``WindowParams``."""
    frames, gt, gt_eyes = clip
    video = str(tmp_path / "v.mp4")
    rng = np.random.default_rng(7)
    if kind == "boxes":
        np.save(video + ".boxes.npy", gt + rng.uniform(-2, 2, gt.shape))
    elif kind == "eyes":
        np.save(video + ".landmarks.npy", gt_eyes)
    elif kind == "dense":
        np.save(video + ".landmarks.npy",
                gt_eyes.mean(1, keepdims=True)
                + rng.normal(0, 9, (len(gt), 68, 2)))
    elif kind == "csv":
        lm = (gt_eyes[:12].mean(1, keepdims=True)
              + rng.normal(0, 9, (12, 68, 2)))
        hdr = (["frame", " face_id", " timestamp", " confidence",
                " success"] + [f" x_{i}" for i in range(68)]
               + [f" y_{i}" for i in range(68)])
        with open(video + ".openface.csv", "w") as f:
            f.write(",".join(hdr) + "\n")
            for i, pts in enumerate(lm):   # 12 rows: the rest hold-pads
                row = [i + 1, 0, i / 25, 0.9, 1] + list(pts[:, 1]) + list(
                    pts[:, 0])
                f.write(",".join(str(v) for v in row) + "\n")
    return video


@pytest.mark.parametrize("kind, align, want_boxes, max_frames", [
    ("none", False, False, None),
    ("none", True, False, None),
    ("boxes", False, False, None),
    ("boxes", True, False, 20),
    ("eyes", True, False, None),
    ("eyes", True, True, None),
    ("dense", True, False, 17),
    ("csv", True, True, None),
])
def test_window_params_equal(tmp_path, clip, kind, align, want_boxes,
                             max_frames):
    """``WindowParams.resolve`` window by window (5 frames, an uneven
    tail): boxes, landmarks and crop params exactly equal, for the
    tracker, a boxes sidecar, eye and dense ``.npy`` sidecars and an
    OpenFace CSV shorter than the video."""
    frames = clip[0][:max_frames]
    video = _sidecars(tmp_path, kind, clip)
    wps = [mod.WindowParams(video, CROP, align=align, max_frames=max_frames,
                            want_boxes=want_boxes)
           for mod in (tdecode, jdecode)]
    for start in range(0, len(frames), 5):
        window = frames[start:start + 5]
        got, want = (wp.resolve(window, start) for wp in wps)
        for a, b in zip(got, want):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)


def test_short_boxes_sidecar_raises(tmp_path, clip):
    video = str(tmp_path / "v.mp4")
    np.save(video + ".boxes.npy", clip[1][:7])
    wp = tdecode.WindowParams(video, CROP)
    wp.resolve(clip[0][:5], 0)
    with pytest.raises(ValueError, match="7 rows"):
        wp.resolve(clip[0][5:10], 5)


def test_sidecar_helpers_equal(tmp_path, clip):
    frames, gt, gt_eyes = clip
    video = str(tmp_path / "v.mp4")
    for mod in (tdecode, jdecode):
        assert mod.resolve_landmarks_path(video) is None
        assert not mod.has_landmark_sidecar(video)
        assert mod.load_boxes_file(video) is None
        assert mod.landmark_source(video) is None
    with pytest.raises(FileNotFoundError):
        tdecode.resolve_landmarks_path(video, str(tmp_path / "nope.npy"))
    with pytest.raises(FileNotFoundError):
        tdecode.load_boxes_file(video, str(tmp_path / "nope.npy"))
    np.save(video + ".boxes.npy", gt)
    np.save(video + ".landmarks.npy", gt_eyes)
    assert tdecode.has_landmark_sidecar(video)
    np.testing.assert_array_equal(tdecode.load_boxes_file(video),
                                  jdecode.load_boxes_file(video))
    np.testing.assert_array_equal(tdecode.load_landmarks(video, 10),
                                  jdecode.load_landmarks(video, 10))
    with pytest.raises(ValueError, match="expected shape"):
        tdecode.load_landmarks(video, len(gt) + 1)
    src = tdecode.landmark_source(video)
    np.testing.assert_array_equal(src.read(20, 3), gt_eyes[20:23])
    with pytest.raises(ValueError, match="landmark rows"):
        src.read(20, 4)
    np.testing.assert_array_equal(tdecode.hold_pad_indices(8, 5, 10),
                                  jdecode.hold_pad_indices(8, 5, 10))
    np.save(str(tmp_path / "bad.npy"), np.zeros((3, 5)))
    with pytest.raises(ValueError, match=r"\[T, 4\] boxes"):
        tdecode.load_boxes_file(boxes_path=str(tmp_path / "bad.npy"))
    np.save(str(tmp_path / "short.npy"), gt[:7])
    with pytest.raises(ValueError, match=r"expected shape \(23, 4\)"):
        tdecode.face_boxes(frames, boxes_path=str(tmp_path / "short.npy"))


def test_decode_and_image_dirs_equal(tmp_path, clip):
    """A written video decodes to the same frames in one piece and in
    windows of 5 (port ``iter_video`` vs JAX ``decode_video``), and a
    frame-image directory reads in numeric order, resized or not."""
    cv2 = pytest.importorskip("cv2")
    frames = clip[0]
    video = str(tmp_path / "v.mp4")
    tdecode.write_video(video, frames)
    whole = jdecode.decode_video(video)
    np.testing.assert_array_equal(tdecode.decode_video(video), whole)
    parts = list(tdecode.iter_video(video, window=5, max_frames=21))
    assert [s for _f, s in parts] == [0, 5, 10, 15, 20]
    np.testing.assert_array_equal(np.concatenate([f for f, _s in parts]),
                                  whole[:21])
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i in (0, 2, 10, 1):
        cv2.imwrite(str(img_dir / f"frame_{i}.png"), frames[i][..., ::-1])
    names = tdecode.list_frame_images(str(img_dir))
    assert names == jdecode.list_frame_images(str(img_dir))
    assert names == [f"frame_{i}.png" for i in (0, 1, 2, 10)]
    for size in (None, 40):
        np.testing.assert_array_equal(
            tdecode.load_image_dir(str(img_dir), size),
            jdecode.load_image_dir(str(img_dir), size))
    with pytest.raises(FileNotFoundError):
        tdecode.decode_video(str(tmp_path / "missing.mp4"))


def test_native_cascade_loader_equal(clip):
    """The port loads the same native library (or none) as the JAX
    package, and its Haar detectors are of the same kind and find the same
    faces."""
    assert tnative.available() == jnative.available()
    assert tnative.cascade("") is None
    got, want = tdecode._haar_detector(), jdecode._haar_detector()
    assert type(got).__name__ == type(want).__name__
    if got is not None:
        gray = clip[0][0].mean(-1).astype(np.uint8)
        assert (list(map(tuple, got.detectMultiScale(gray, 1.1, 3)))
                == list(map(tuple, want.detectMultiScale(gray, 1.1, 3))))
