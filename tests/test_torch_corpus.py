"""The port's corpus runner (``mimamo_tpu_torch.corpus``) and its native
loader bindings, the cases of tests/test_native.py: run and resume, the
manifest rows, short videos, the Python stream's window seams,
two-process sharding, per-video failure isolation, aligned runs. The
per-video CSVs are held against the JAX ``CorpusRunner`` with the same
weights (``weights.from_jax_variables``) at atol 1e-5; aligned runs
against the port's own ``MimamoAPI.predict(align=True)``. The native
loader's cases build the library at first use
(``native_loader.build``, into ``mimamo_tpu_torch/_build/``) and skip only
where it cannot build (no ``g++`` or no OpenCV 4 headers)."""

import json
import os

import numpy as np
import pytest

from mimamo_tpu import corpus as jcorpus
from mimamo_tpu import parallel as jparallel
from mimamo_tpu.runner import Mimamo as JaxMimamo
from mimamo_tpu_torch import api, corpus
from mimamo_tpu_torch.corpus import CorpusRunner
from mimamo_tpu_torch.io import decode, native_loader
from mimamo_tpu_torch.runner import Mimamo

from test_torch_decode import (  # noqa: F401
    drop_if_passed, drop_passed_tmp_path, same_native_library)
from test_torch_serve import small_configs, small_weights

pytest.importorskip("cv2")

ATOL = 1e-5
LENGTHS = [14, 9, 20]


@pytest.fixture
def needs_native():
    """Builds the native library (decided here, not at import: the test
    workers must all collect the same tests)."""
    if not native_loader.available():
        pytest.skip(f"native library: {native_loader.build_error()}")


@pytest.fixture(scope="module")
def corpus_dir(request, tmp_path_factory):
    failed = request.session.testsfailed
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    for i, t in enumerate(LENGTHS):
        frames = rng.uniform(0, 255, (t, 48, 64, 3)).astype(np.uint8)
        decode.write_video(str(root / f"v{i}.mp4"), frames)
    yield root
    drop_if_passed(root, failed, request.session.testsfailed)


def _paths(root):
    return [str(root / f"v{i}.mp4") for i in range(3)]


@pytest.fixture(scope="module")
def case():
    jcfg, tcfg = small_configs()
    variables, state = small_weights(1)
    model = Mimamo(tcfg, device="cpu")
    model.load_state_dict(state)
    return model, JaxMimamo(jcfg), variables


@pytest.fixture(scope="module")
def jax_csvs(request, case, corpus_dir, tmp_path_factory):
    """The JAX CorpusRunner's CSVs of the three videos (Python loader)."""
    _m, jmodel, variables = case
    failed = request.session.testsfailed
    root = tmp_path_factory.mktemp("jax_out")
    out = str(root)
    stats = jcorpus.CorpusRunner(jmodel, variables, out, batch_clips=2,
                                 use_native=False).run(_paths(corpus_dir))
    assert stats["videos"] == 3
    yield out
    drop_if_passed(root, failed, request.session.testsfailed)


def _csv(path):
    return np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)


def _manifest(out_dir, name="manifest.jsonl"):
    with open(os.path.join(out_dir, name)) as f:
        return {row["video"]: row for row in map(json.loads, f)}


class TestNativeLoader:
    @pytest.mark.usefixtures("needs_native")
    def test_clip_stream_shapes_and_coverage(self, corpus_dir):
        clips, eovs = [], {}
        with native_loader.NativeCorpusLoader(
                _paths(corpus_dir), clip_len=8, stride=4, crop=32,
                n_threads=2) as loader:
            for clip, vi, start in loader:
                if vi < 0:
                    eovs[~vi] = start
                else:
                    assert clip.shape == (8, 32, 32, 3)
                    assert clip.dtype == np.uint8
                    clips.append((vi, start))
        assert eovs == {i: t for i, t in enumerate(LENGTHS)}
        starts = {vi: sorted(s for v, s in clips if v == vi)
                  for vi in range(3)}
        assert starts == {0: [0, 4, 6], 1: [0, 1], 2: [0, 4, 8, 12]}

    @pytest.mark.usefixtures("needs_native")
    def test_decode_failure_sentinel(self, tmp_path):
        with native_loader.NativeCorpusLoader(
                [str(tmp_path / "missing.mp4")], clip_len=8, stride=4,
                crop=32, n_threads=1) as loader:
            out = list(loader)
        assert out[0][1] == ~0 and out[0][2] == -1

    @pytest.mark.usefixtures("needs_native")
    def test_decode_video_native(self, corpus_dir):
        crops, boxes, eyes = native_loader.decode_video_native(
            str(corpus_dir / "v0.mp4"), crop=32)
        assert crops.shape == (LENGTHS[0], 32, 32, 3)
        # no face in noise: the centered square box
        np.testing.assert_allclose(boxes[0], [0.0, 8.0, 48.0, 48.0])
        y0, x0, bh, bw = boxes[0]
        np.testing.assert_allclose(
            eyes[0], [[y0 + 0.38 * bh, x0 + 0.22 * bw],
                      [y0 + 0.38 * bh, x0 + 0.78 * bw]], rtol=1e-5)

    def test_unbuilt_library_raises(self, monkeypatch):
        """Where the library does not build, ``available()`` is False,
        ``build_error()`` says why, and the loader and
        ``decode_video_native`` raise with that text."""
        def no_compiler():
            raise RuntimeError("g++ not found")

        monkeypatch.setattr(native_loader, "_LIB_PATHS", ())
        monkeypatch.setattr(native_loader, "_NATIVE",
                            native_loader._Library(build=no_compiler))
        assert not native_loader.available()
        assert native_loader.build_error().startswith("g++ not found")
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            native_loader.NativeCorpusLoader(["x.mp4"], 8, 4, 32)
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            native_loader.decode_video_native("x.mp4", 32)
        assert native_loader.cascade("x.xml") is None

    @pytest.mark.usefixtures("needs_native")
    def test_library_builds_outside_native(self):
        """The library is compiled into the port's build directory, keyed
        by the source's hash, and ``native/`` gets no build product."""
        before = sorted(os.listdir(native_loader.SOURCE.parent))
        path = native_loader.build()
        assert path.parent == native_loader.BUILD_DIR
        assert path.name.startswith("libmimamo_native_") and path.exists()
        assert native_loader.build() == path          # no rebuild
        assert sorted(os.listdir(native_loader.SOURCE.parent)) == before


class TestCorpusRunner:
    @pytest.mark.parametrize("use_native", [True, False])
    def test_run_and_resume(self, case, corpus_dir, jax_csvs, tmp_path,
                            use_native):
        """Three videos: T + 1 CSV lines each, ``ok`` manifest rows, the
        JAX runner's series at atol 1e-5 (Python loader); a second run
        skips all three."""
        if use_native and not native_loader.available():
            pytest.skip(f"native library: {native_loader.build_error()}")
        model = case[0]
        out = str(tmp_path / "out")
        runner = CorpusRunner(model, out, batch_clips=2,
                              use_native=use_native, loader_threads=2)
        stats = runner.run(_paths(corpus_dir))
        assert stats["videos"] == 3 and stats["failed"] == 0
        assert stats["frames"] == sum(LENGTHS)
        rows = _manifest(out)
        for i, t in enumerate(LENGTHS):
            got = _csv(os.path.join(out, f"v{i}.csv"))
            assert got.shape == (t, 3)
            assert rows[_paths(corpus_dir)[i]]["status"] == "ok"
            if not use_native:
                np.testing.assert_allclose(
                    got, _csv(os.path.join(jax_csvs, f"v{i}.csv")),
                    atol=ATOL, rtol=0)
        stats2 = CorpusRunner(model, out, batch_clips=2,
                              use_native=use_native).run(_paths(corpus_dir))
        assert stats2["videos"] == 0 and stats2["resumed_skipped"] == 3

    def test_partial_resume(self, case, corpus_dir, tmp_path):
        paths = _paths(corpus_dir)
        out = str(tmp_path / "partial")
        os.makedirs(out)
        with open(os.path.join(out, "manifest.jsonl"), "w") as f:
            f.write(json.dumps({"video": paths[0], "status": "ok",
                                "frames": LENGTHS[0]}) + "\n")
        stats = CorpusRunner(case[0], out, batch_clips=2,
                             use_native=False).run(paths)
        assert stats["resumed_skipped"] == 1 and stats["videos"] == 2

    def test_incomplete_rows_are_retried_on_resume(self, case, corpus_dir,
                                                   tmp_path):
        """"incomplete" is retried; a terminal row is not."""
        paths = _paths(corpus_dir)
        out = str(tmp_path / "retry")
        os.makedirs(out)
        with open(os.path.join(out, "manifest.jsonl"), "w") as f:
            f.write(json.dumps({"video": paths[0],
                                "status": "incomplete"}) + "\n")
            f.write(json.dumps({"video": paths[1], "status": "ok",
                                "frames": 9}) + "\n")
        stats = CorpusRunner(case[0], out, batch_clips=2,
                             use_native=False).run(paths)
        assert stats["resumed_skipped"] == 1
        assert stats["videos"] == 2
        assert os.path.exists(os.path.join(out, "v0.csv"))

    def test_two_process_sharding_disjoint(self, case, corpus_dir,
                                           tmp_path):
        """Two processes over one out_dir work disjoint round-robin slices
        (``shard_paths``, as the JAX package's) with a manifest each; a
        resume on either skips the other's work too."""
        paths = _paths(corpus_dir)
        for pid in (0, 1):
            assert (corpus.shard_paths(paths, pid, 2)
                    == jparallel.shard_paths(paths, pid, 2))
        with pytest.raises(ValueError, match="out of range"):
            corpus.shard_paths(paths, 2, 2)
        out = str(tmp_path / "mp")
        s0, s1 = (CorpusRunner(case[0], out, batch_clips=2,
                               use_native=False, process_id=pid,
                               process_count=2).run(paths)
                  for pid in (0, 1))
        assert (s0["videos"], s1["videos"]) == (2, 1)
        for pid in (0, 1):
            assert os.path.exists(os.path.join(out,
                                               f"manifest.p{pid}.jsonl"))
            again = CorpusRunner(case[0], out, batch_clips=2,
                                 use_native=False, process_id=pid,
                                 process_count=2).run(paths)
            assert again["videos"] == 0
        for i in range(3):
            assert os.path.exists(os.path.join(out, f"v{i}.csv"))

    def test_even_smooth_rejected_at_init(self, case, tmp_path):
        with pytest.raises(ValueError, match="odd"):
            CorpusRunner(case[0], str(tmp_path / "o"), smooth=4)

    def test_smoothed_csv_matches_jax(self, case, corpus_dir, tmp_path):
        """``smooth=3`` against the JAX runner's smoothed CSV."""
        model, jmodel, variables = case
        path = [_paths(corpus_dir)[2]]
        got, want = str(tmp_path / "port"), str(tmp_path / "jax")
        CorpusRunner(model, got, batch_clips=2, use_native=False,
                     smooth=3).run(path)
        jcorpus.CorpusRunner(jmodel, variables, want, batch_clips=2,
                             use_native=False, smooth=3).run(path)
        np.testing.assert_allclose(_csv(os.path.join(got, "v2.csv")),
                                   _csv(os.path.join(want, "v2.csv")),
                                   atol=ATOL, rtol=0)


class TestShortVideos:
    """Videos shorter than a clip: one clip padded by its last crop, the
    outputs cut back to the real frame count."""

    @pytest.fixture(scope="class")
    def short_dir(self, request, tmp_path_factory):
        failed = request.session.testsfailed
        root = tmp_path_factory.mktemp("short")
        rng = np.random.default_rng(1)
        decode.write_video(str(root / "tiny.mp4"), rng.uniform(
            0, 255, (5, 48, 64, 3)).astype(np.uint8))
        yield root
        drop_if_passed(root, failed, request.session.testsfailed)

    @pytest.mark.usefixtures("needs_native")
    def test_native_loader_pads_short_video(self, short_dir):
        clips = []
        with native_loader.NativeCorpusLoader(
                [str(short_dir / "tiny.mp4")], clip_len=8, stride=4,
                crop=32, n_threads=1) as loader:
            for clip, vi, start in loader:
                if vi >= 0:
                    clips.append((clip, start))
                else:
                    assert start == 5
        assert len(clips) == 1
        clip, start = clips[0]
        assert start == 0 and clip.shape == (8, 32, 32, 3)
        np.testing.assert_array_equal(clip[7], clip[4])

    @pytest.mark.parametrize("use_native", [True, False])
    def test_corpus_runner_short_video_csv(self, case, short_dir, tmp_path,
                                           use_native):
        """A 5-frame video: 1 + 5 CSV lines equal to the JAX runner's; an
        unreadable file is ``decode_failed``."""
        if use_native and not native_loader.available():
            pytest.skip(f"native library: {native_loader.build_error()}")
        model, jmodel, variables = case
        tiny = str(short_dir / "tiny.mp4")
        missing = str(short_dir / "missing.mp4")
        out = str(tmp_path / "short")
        stats = CorpusRunner(model, out, batch_clips=2,
                             use_native=use_native,
                             loader_threads=1).run([tiny, missing])
        assert stats["videos"] == 1 and stats["frames"] == 5
        assert stats["failed"] == 1
        rows = _manifest(out)
        assert rows[tiny]["status"] == "ok"
        assert rows[missing]["status"] == "decode_failed"
        got = _csv(os.path.join(out, "tiny.csv"))
        assert got.shape == (5, 3)
        if not use_native:
            want = str(tmp_path / "jax")
            jcorpus.CorpusRunner(jmodel, variables, want, batch_clips=2,
                                 use_native=False).run([tiny])
            np.testing.assert_allclose(
                got, _csv(os.path.join(want, "tiny.csv")), atol=ATOL,
                rtol=0)


class TestPythonStream:
    def test_window_seam_invariance(self, case, corpus_dir, tmp_path):
        """The same clips and starts for any decode window (rolling-buffer
        seams, stride tails, short-video padding), and the same stream as
        the JAX package's Python loader."""
        model, jmodel, variables = case
        rng = np.random.default_rng(7)
        short = str(tmp_path / "short5.mp4")
        decode.write_video(
            short, rng.uniform(0, 255, (5, 48, 64, 3)).astype(np.uint8))
        paths = _paths(corpus_dir) + [short]
        runner = CorpusRunner(model, str(tmp_path / "o"), use_native=False)
        small = list(runner._python_clip_stream(paths, decode_window=5))
        big = list(runner._python_clip_stream(paths,
                                              decode_window=10_000))
        jax_stream = list(jcorpus.CorpusRunner(
            jmodel, variables, str(tmp_path / "j"),
            use_native=False)._python_clip_stream(paths, decode_window=5))
        assert len(small) == len(big) == len(jax_stream)
        for (ca, va, sa), (cb, vb, sb), (cj, vj, sj) in zip(small, big,
                                                            jax_stream):
            assert (va, sa) == (vb, sb) == (vj, sj)
            if va >= 0:
                np.testing.assert_array_equal(ca, cb)
                np.testing.assert_array_equal(ca, cj)
        assert [s for c, v, s in big if v == 3] == [0]
        assert [s for c, v, s in big if v == ~3] == [5]


class TestAligned:
    def _eye_sidecar(self, video, t):
        lm = np.zeros((t, 2, 2), np.float32)   # a drifting eye pair
        lm[:, 0, 0] = lm[:, 1, 0] = 18 + 0.25 * np.arange(t)
        lm[:, 0, 1] = 24 + 0.1 * np.arange(t)
        lm[:, 1, 1] = 40 + 0.1 * np.arange(t)
        np.save(video + ".landmarks.npy", lm)

    def test_aligned_corpus_matches_api_predict(self, case, corpus_dir,
                                                tmp_path):
        """``align=True`` with a landmark sidecar equals
        ``MimamoAPI.predict(align=True)`` frame by frame: both warp on the
        device through ``crop_video_chunked``. ``use_native=True`` on
        purpose: a sidecar video takes the Python stream either way."""
        model = case[0]
        video = str(tmp_path / "v2.mp4")
        os.symlink(corpus_dir / "v2.mp4", video)
        self._eye_sidecar(video, LENGTHS[2])
        out = str(tmp_path / "aligned")
        runner = CorpusRunner(model, out, batch_clips=2, use_native=True,
                              align=True)
        stats = runner.run([video])
        assert stats["videos"] == 1
        got = _csv(os.path.join(out, "v2.csv"))[:, 1:]
        a = api.MimamoAPI(config=model.config, state_dict=model.state_dict(),
                          device="cpu")
        want = a.predict(video, align=True)
        assert got.shape == want.shape == (LENGTHS[2], 2)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)

    def test_corrupt_sidecar_fails_only_its_video(self, case, corpus_dir,
                                                  tmp_path):
        """A corrupt sidecar records its video ``decode_failed``; the rest
        of the corpus completes."""
        paths = []
        for i in range(3):
            p = str(tmp_path / f"v{i}.mp4")
            os.symlink(corpus_dir / f"v{i}.mp4", p)
            paths.append(p)
        with open(paths[0] + ".landmarks.npy", "wb") as f:
            f.write(b"not a numpy file at all")
        out = str(tmp_path / "corrupt")
        stats = CorpusRunner(case[0], out, batch_clips=2, use_native=False,
                             align=True).run(paths)
        assert stats["videos"] == 2 and stats["failed"] == 1
        rows = _manifest(out)
        assert rows[paths[0]]["status"] == "decode_failed"
        assert all(rows[p]["status"] == "ok" for p in paths[1:])

    def test_dense_csv_shorter_than_video_matches_api(self, case,
                                                      corpus_dir, tmp_path):
        """An OpenFace CSV with fewer rows than the video: the corpus
        stream and ``MimamoAPI.predict`` fit the template over the raw
        rows and hold the last transform past the end, so the CSVs
        agree."""
        model = case[0]
        video = str(tmp_path / "v2.mp4")
        os.symlink(corpus_dir / "v2.mp4", video)
        theta = np.linspace(0, 2 * np.pi, 68, endpoint=False)
        header = (["frame", " face_id", " timestamp", " confidence",
                   " success"] + [f" x_{i}" for i in range(68)]
                  + [f" y_{i}" for i in range(68)])
        with open(video + ".openface.csv", "w") as f:
            f.write(",".join(header) + "\n")
            for i in range(12):
                xs = 32 + (14 + 0.2 * i) * np.cos(theta) + 0.3 * i
                ys = 24 + (11 + 0.1 * i) * np.sin(theta)
                row = ([i + 1, 0, i / 25.0, 0.9, 1] + list(np.round(xs, 3))
                       + list(np.round(ys, 3)))
                f.write(",".join(str(v) for v in row) + "\n")
        out = str(tmp_path / "densecsv")
        stats = CorpusRunner(model, out, batch_clips=2, use_native=False,
                             align=True).run([video])
        assert stats["videos"] == 1
        got = _csv(os.path.join(out, "v2.csv"))[:, 1:]
        want = api.MimamoAPI(config=model.config,
                             state_dict=model.state_dict(),
                             device="cpu").predict(video, align=True)
        assert got.shape == want.shape == (LENGTHS[2], 2)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
