"""The port's serving daemon (``mimamo_tpu_torch.serve``) against the JAX
package's (``mimamo_tpu.serve``), the cases of tests/test_serve.py: the
protocol (errors never kill the daemon, ids echo back, the stream
lifecycle, the allowed root, predict on a worker thread) and the numbers
(stream values against a ``StreamingSession`` and against the JAX
``Server`` with the same weights, at atol 1e-5), and
``python -m mimamo_tpu_torch.cli serve --cpu`` as a subprocess.

The config is the small one of tests/test_api.py's CLI cases (crops of
32, 2 x 2 pyramid, phase maps of 16, clips of 8 at stride 4) with the
backbone at 64, twice the crop, as the port runs it. The weights come
from the JAX package through ``weights.from_jax_variables``."""

import functools
import io
import json
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest

from mimamo_tpu import config as jc
from mimamo_tpu import serve as jserve
from mimamo_tpu.runner import Mimamo as JaxMimamo
from mimamo_tpu_torch import config as tc
from mimamo_tpu_torch import serve, weights
from mimamo_tpu_torch.io import decode
from mimamo_tpu_torch.streaming import StreamingSession

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, CLIP, STRIDE = 32, 8, 4
ATOL = 1e-5
# the same config as command-line flags (the CLI tests and the subprocess)
SMALL_FLAGS = ["--crop-size", str(S), "--backbone-size", str(2 * S),
               "--pyramid-height", "2", "--orientations", "2",
               "--phase-size", "16", "--clip-len", str(CLIP),
               "--stride", str(STRIDE)]


def small_configs():
    """(JAX config, port config) of the slice's tests."""
    def make(m):
        return m.MimamoConfig(
            pyramid=m.PyramidSpec(height=2, orientations=2,
                                  input_size=(S, S)),
            phase=m.PhaseSpec(phase_size=16),
            backbone=m.BackboneSpec(input_size=2 * S),
            clip=m.ClipSpec(clip_len=CLIP, stride=STRIDE, crop_size=S))
    return make(jc), make(tc)


def small_weights(seed=0):
    """(JAX variables as numpy, the port's state_dict of them)."""
    jcfg, _ = small_configs()
    init = jax.jit(functools.partial(JaxMimamo(jcfg).init_variables,
                                     clip_len=CLIP))
    variables = jax.tree_util.tree_map(np.asarray,
                                       init(jax.random.PRNGKey(seed)))
    return variables, weights.from_jax_variables(variables)


@pytest.fixture(scope="module")
def case():
    jcfg, tcfg = small_configs()
    variables, state = small_weights()
    return jcfg, tcfg, variables, state


@pytest.fixture(scope="module")
def server(case):
    _j, tcfg, _v, state = case
    return serve.Server(config=tcfg, state_dict=state, capacity=3, chunk=4,
                        device="cpu")


@pytest.fixture(scope="module")
def jax_server(case):
    jcfg, _t, variables, _s = case
    return jserve.Server(config=jcfg, variables=variables, capacity=3,
                         chunk=4)


def _port_server(case, **kw):
    _j, tcfg, _v, state = case
    kw = {"capacity": 2, "chunk": 4, **kw}
    return serve.Server(config=tcfg, state_dict=state, device="cpu", **kw)


def _chunk(seed=0, t=4, s=S):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 255, (t, s, s, 3)).astype(np.float32)


class TestDispatch:
    def test_ping_and_id_echo(self, server):
        r = server.handle({"cmd": "ping", "id": "abc"})
        assert r["ok"] and r["id"] == "abc"
        assert r["capacity"] == 3 and r["chunk"] == 4

    def test_unknown_cmd_is_error_not_crash(self, server):
        r = server.handle({"cmd": "explode"})
        assert not r["ok"] and "unknown cmd" in r["error"]
        r = server.handle({"no_cmd": 1})
        assert not r["ok"]

    def test_stream_lifecycle_and_values(self, server, jax_server):
        """Values through the protocol equal a StreamingSession on the
        same model to the protocol's 6 decimals, and the JAX Server's at
        atol 1e-5."""
        ref = StreamingSession(server.api.model, capacity=3, chunk=4)
        slot = ref.add_stream()
        c1, c2 = _chunk(1), _chunk(2)
        want = np.concatenate([ref.feed({slot: c1})[slot],
                               ref.feed({slot: c2})[slot]])
        results = {}
        for name, srv in (("port", server), ("jax", jax_server)):
            assert srv.handle({"cmd": "stream_open", "stream": "s1"})["ok"]
            got = []
            for c in (c1, c2):
                r = srv.handle({"cmd": "stream_feed", "stream": "s1",
                                "data": c.tolist()})
                assert r["ok"], r
                got.extend(r["values"])
            assert srv.handle({"cmd": "stream_close", "stream": "s1"})["ok"]
            results[name] = np.asarray(got)
        # the protocol rounds to 6 decimals
        np.testing.assert_allclose(results["port"], want, atol=1e-6, rtol=0)
        np.testing.assert_allclose(results["port"], results["jax"],
                                   atol=ATOL, rtol=0)

    def test_stream_errors(self, server):
        assert not server.handle(
            {"cmd": "stream_feed", "stream": "nope", "data": []})["ok"]
        assert not server.handle(
            {"cmd": "stream_close", "stream": "nope"})["ok"]
        server.handle({"cmd": "stream_open", "stream": "dup"})
        r = server.handle({"cmd": "stream_open", "stream": "dup"})
        assert not r["ok"] and "already open" in r["error"]
        # wrong chunk shape -> error, stream still usable
        r = server.handle({"cmd": "stream_feed", "stream": "dup",
                           "data": _chunk(t=3).tolist()})
        assert not r["ok"]
        r = server.handle({"cmd": "stream_feed", "stream": "dup",
                           "data": _chunk().tolist()})
        assert r["ok"]
        server.handle({"cmd": "stream_close", "stream": "dup"})

    def test_feed_from_npy_path(self, server, tmp_path):
        p = str(tmp_path / "c.npy")
        np.save(p, _chunk(5))
        server.handle({"cmd": "stream_open", "stream": "f"})
        r = server.handle({"cmd": "stream_feed", "stream": "f",
                           "crops": p})
        assert r["ok"] and len(r["values"]) == 4
        server.handle({"cmd": "stream_close", "stream": "f"})

    def test_stream_feed_multi_matches_jax_server(self, server, jax_server,
                                                  tmp_path):
        """One ``stream_feed_multi`` (one forward for two streams, from an
        npy path and an inline array) equals one StreamingSession.feed
        with the same slots, and the JAX Server's answer at atol 1e-5."""
        ref = StreamingSession(server.api.model, capacity=3, chunk=4)
        ca, cb = _chunk(21), _chunk(22)
        sa, sb = ref.add_stream(), ref.add_stream()
        want = ref.feed({sa: ca, sb: cb})
        p = str(tmp_path / "m.npy")
        np.save(p, ca)
        got = {}
        for name, srv in (("port", server), ("jax", jax_server)):
            for n in ("ma", "mb"):
                assert srv.handle({"cmd": "stream_open", "stream": n})["ok"]
            r = srv.handle({"cmd": "stream_feed_multi",
                            "streams": {"ma": p, "mb": cb.tolist()}})
            assert r["ok"], r
            got[name] = {n: np.asarray(v) for n, v in r["values"].items()}
        np.testing.assert_allclose(got["port"]["ma"], want[sa], atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(got["port"]["mb"], want[sb], atol=1e-6,
                                   rtol=0)
        for n in ("ma", "mb"):
            np.testing.assert_allclose(got["port"][n], got["jax"][n],
                                       atol=ATOL, rtol=0)
        # error paths: an unopened name, an empty mapping; it survives
        r = server.handle({"cmd": "stream_feed_multi",
                           "streams": {"ma": p, "nope": p}})
        assert not r["ok"] and "nope" in r["error"]
        assert not server.handle({"cmd": "stream_feed_multi",
                                  "streams": {}})["ok"]
        for srv in (server, jax_server):
            for n in ("ma", "mb"):
                assert srv.handle({"cmd": "stream_close", "stream": n})["ok"]

    def test_capacity_exhaustion_is_error(self, server):
        names = [f"cap{i}" for i in range(4)]
        opened = []
        try:
            for n in names:
                r = server.handle({"cmd": "stream_open", "stream": n})
                (opened.append(n) if r["ok"] else None)
            assert len(opened) == 3  # capacity 3; the 4th errs, no crash
        finally:
            for n in opened:
                server.handle({"cmd": "stream_close", "stream": n})


class TestUint8Session:
    def test_inline_floats_round_not_truncate(self, case):
        """A uint8 session rounds client float pixels: 100.9 and 101.0
        give the same values."""
        srv = _port_server(case, stream_dtype=np.uint8)
        base = np.full((4, S, S, 3), 100.0, np.float32)
        srv.handle({"cmd": "stream_open", "stream": "a"})
        srv.handle({"cmd": "stream_open", "stream": "b"})
        ra = srv.handle({"cmd": "stream_feed", "stream": "a",
                         "data": (base + 0.9).tolist()})
        rb = srv.handle({"cmd": "stream_feed", "stream": "b",
                         "data": (base + 1.0).tolist()})
        assert ra["ok"] and rb["ok"]
        np.testing.assert_allclose(ra["values"], rb["values"])


class TestRunLoop:
    def test_jsonl_loop(self, server):
        fin = io.StringIO(
            '{"cmd": "ping", "id": 1}\n'
            "not json\n"
            "\n"
            '{"cmd": "shutdown"}\n'
            '{"cmd": "ping", "id": "never-reached"}\n')
        fout = io.StringIO()
        serve.run(server, fin, fout)
        lines = [json.loads(x) for x in fout.getvalue().splitlines()]
        assert lines[0]["ok"] and lines[0]["id"] == 1
        assert not lines[1]["ok"] and "bad request" in lines[1]["error"]
        assert lines[2]["shutdown"]
        assert len(lines) == 3   # the loop exited on shutdown


class TestConcurrentPredict:
    def test_stream_feeds_not_starved_by_slow_predict(self, case,
                                                      monkeypatch):
        """A slow predict does not stall the streams: its response is
        written when it is done (id-correlated, out of order) while the
        stream commands go on on the main thread. The predict waits until
        the feed's response has been written, which only an asynchronous
        predict allows."""
        srv = _port_server(case)
        fed = threading.Event()

        def slow_predict(video, **kw):
            fed.wait(timeout=60)
            return np.zeros((5, 2), np.float32)

        monkeypatch.setattr(srv.api, "predict", slow_predict)

        class FlaggingOut(io.StringIO):
            def write(self, s):
                n = super().write(s)
                if '"id": "f"' in s:
                    fed.set()
                return n

        fin = io.StringIO(
            '{"cmd": "predict", "video": "x.mp4", "id": "P"}\n'
            '{"cmd": "stream_open", "stream": "s", "id": "o"}\n'
            '{"cmd": "stream_feed", "stream": "s", "id": "f", '
            '"data": ' + json.dumps(_chunk().tolist()) + '}\n'
            '{"cmd": "stream_close", "stream": "s", "id": "c"}\n'
            '{"cmd": "shutdown"}\n')
        fout = FlaggingOut()
        serve.run(srv, fin, fout)
        lines = [json.loads(x) for x in fout.getvalue().splitlines()]
        order = [line.get("id") for line in lines]
        assert order.index("f") < order.index("P")
        by_id = {line.get("id"): line for line in lines}
        assert by_id["P"]["ok"] and by_id["P"]["frames"] == 5
        assert by_id["o"]["ok"] and by_id["f"]["ok"] and by_id["c"]["ok"]

    def test_sync_mode_keeps_strict_order(self, case, monkeypatch):
        srv = _port_server(case)
        monkeypatch.setattr(
            srv.api, "predict",
            lambda video, **kw: np.zeros((3, 2), np.float32))
        fin = io.StringIO(
            '{"cmd": "predict", "video": "x.mp4", "id": "P"}\n'
            '{"cmd": "ping", "id": "g"}\n'
            '{"cmd": "shutdown"}\n')
        fout = io.StringIO()
        serve.run(srv, fin, fout, predict_async=False)
        ids = [json.loads(x).get("id")
               for x in fout.getvalue().splitlines()]
        assert ids[:2] == ["P", "g"]


class TestAllowedRoot:
    def test_paths_outside_root_rejected(self, case, tmp_path):
        srv = _port_server(case, allowed_root=str(tmp_path))
        r = srv.handle({"cmd": "predict", "video": "/etc/passwd"})
        assert not r["ok"] and "allowed root" in r["error"]
        r = srv.handle({"cmd": "predict",
                        "video": str(tmp_path / ".." / "escape.mp4")})
        assert not r["ok"] and "allowed root" in r["error"]
        # writes are covered too
        r = srv.handle({"cmd": "predict", "video": str(tmp_path / "v"),
                        "out_csv": "/tmp/evil.csv"})
        assert not r["ok"] and "allowed root" in r["error"]
        # inside the root: passes the check
        srv.handle({"cmd": "stream_open", "stream": "s"})
        p = str(tmp_path / "c.npy")
        np.save(p, _chunk(5))
        assert srv.handle({"cmd": "stream_feed", "stream": "s",
                           "crops": p})["ok"]
        r = srv.handle({"cmd": "stream_feed", "stream": "s",
                        "crops": "/tmp/outside.npy"})
        assert not r["ok"] and "allowed root" in r["error"]
        # the predict 'crops' path goes through the same restriction
        r = srv.handle({"cmd": "predict", "crops": "/tmp/outside.npy"})
        assert not r["ok"] and "allowed root" in r["error"]


class TestPredictCropsRequest:
    def test_predict_crops_matches_jax_server(self, server, jax_server,
                                              tmp_path):
        """``predict`` with precomputed crops: the series equals the
        model's ``predict_from_crops`` and the JAX Server's answer at atol
        1e-5."""
        rng = np.random.default_rng(11)
        crops = rng.uniform(0, 255, (10, S, S, 3)).astype(np.uint8)
        p = str(tmp_path / "crops.npy")
        np.save(p, crops)
        req = {"cmd": "predict", "crops": p, "series": True}
        r, jr = server.handle(req), jax_server.handle(req)
        assert r["ok"] and jr["ok"], (r, jr)
        assert r["frames"] == jr["frames"] == 10
        want = server.api.model.predict_from_crops(crops)
        np.testing.assert_allclose(np.asarray(r["series"]), want, atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(np.asarray(r["series"]),
                                   np.asarray(jr["series"]), atol=ATOL,
                                   rtol=0)
        for k in ("valence_mean", "arousal_mean"):
            assert abs(r[k] - jr[k]) <= ATOL

    def test_predict_arg_coherence_errors(self, server, tmp_path):
        p = str(tmp_path / "c.npy")
        np.save(p, np.zeros((4, S, S, 3), np.uint8))
        r = server.handle({"cmd": "predict"})
        assert not r["ok"] and "exactly one" in r["error"]
        r = server.handle({"cmd": "predict", "crops": p,
                           "video": "x.mp4"})
        assert not r["ok"] and "exactly one" in r["error"]
        r = server.handle({"cmd": "predict", "crops": p, "align": True})
        assert not r["ok"] and "already aligned" in r["error"]


class TestServeCLI:
    def test_subprocess_session(self, tmp_path):
        """A whole daemon session through ``python -m
        mimamo_tpu_torch.cli serve --cpu``: the ready line, ping, predict
        on a written video, a stream round, shutdown; the stream values
        equal an in-process Server with the same seed's weights."""
        pytest.importorskip("cv2")
        vid = str(tmp_path / "v.mp4")
        rng = np.random.default_rng(0)
        decode.write_video(vid, rng.integers(0, 255, (12, 48, 64, 3),
                                             np.uint8))
        crops = str(tmp_path / "c.npy")
        np.save(crops, _chunk(7))
        reqs = "\n".join([
            json.dumps({"cmd": "ping", "id": "p"}),
            json.dumps({"cmd": "predict", "video": vid, "id": "v",
                        "max_frames": 10, "series": True}),
            json.dumps({"cmd": "stream_open", "stream": "s"}),
            json.dumps({"cmd": "stream_feed", "stream": "s",
                        "crops": crops}),
            json.dumps({"cmd": "shutdown"}),
        ]) + "\n"
        env = dict(os.environ, PYTHONPATH=REPO)
        r = subprocess.run(
            [sys.executable, "-m", "mimamo_tpu_torch.cli", "serve",
             *SMALL_FLAGS, "--chunk", "4", "--capacity", "2", "--cpu"],
            input=reqs, capture_output=True, text=True, env=env, cwd=REPO,
            timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        lines = [json.loads(x) for x in r.stdout.splitlines()]
        assert lines[0]["ready"]
        by_id = {line.get("id"): line for line in lines[1:]}
        assert by_id["p"]["ok"]
        assert by_id["v"]["ok"] and by_id["v"]["frames"] == 10
        assert len(by_id["v"]["series"]) == 10
        feeds = [line for line in lines if "values" in line]
        assert len(feeds) == 1 and len(feeds[0]["values"]) == 4
        # the predict's response may come after the shutdown's: in-flight
        # work is drained before exit
        assert any(line.get("shutdown") for line in lines)
        local = serve.Server(config=small_configs()[1], capacity=2, chunk=4,
                             stream_dtype=np.float32, device="cpu")
        local.handle({"cmd": "stream_open", "stream": "s"})
        want = local.handle({"cmd": "stream_feed", "stream": "s",
                             "crops": crops})["values"]
        np.testing.assert_allclose(feeds[0]["values"], want, atol=1e-6,
                                   rtol=0)
