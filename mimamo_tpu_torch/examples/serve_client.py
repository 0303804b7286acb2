"""Serving-daemon client example: drive ``cli serve`` as a subprocess.

Counterpart of ``examples/serve_client.py``: the JSON-lines protocol end
to end (docs/SERVING.md §4) with the same requests and the same small
config: start the daemon, predict a whole video while a live stream is fed
chunk by chunk, feed two streams in one request, shut down. The same
framing works over any byte stream (a socket in place of the pipes)::

    python -m mimamo_tpu_torch.examples.serve_client [--cpu] [--out-dir D]

The daemon runs on the card, or on the CPU with ``--cpu``.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

from mimamo_tpu_torch.examples.demo import synthesize_video

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class DaemonClient:
    """Minimal blocking client over the daemon's stdin/stdout pipes."""

    def __init__(self, extra_args=(), cwd=None, env=None):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "mimamo_tpu_torch.cli", "serve",
             *extra_args],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            cwd=cwd, env=env)
        banner = json.loads(self.proc.stdout.readline())
        if not banner.get("ready"):
            raise RuntimeError(f"daemon did not start: {banner}")

    def send(self, **req) -> None:
        """Send a request without waiting (pair with :meth:`read` and an
        ``id``: predict responses can arrive out of order)."""
        self.proc.stdin.write(json.dumps(req) + "\n")
        self.proc.stdin.flush()

    def read(self) -> dict:
        resp = json.loads(self.proc.stdout.readline())
        # surface the daemon's errors rather than a later KeyError
        if not resp.get("ok", False) and not resp.get("shutdown"):
            raise RuntimeError(f"daemon error: {resp.get('error', resp)}")
        return resp

    def request(self, **req) -> dict:
        self.send(**req)
        return self.read()

    def close(self) -> dict:
        resp = self.request(cmd="shutdown")
        self.proc.wait(timeout=60)
        return resp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run the daemon on the CPU (default: the card)")
    ap.add_argument("--out-dir", default=os.path.join(
        tempfile.gettempdir(), "mimamo_serve_demo"))
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)

    video = os.path.join(args.out_dir, "sample.mp4")
    synthesize_video(video, frames=64)

    # a small config, so the daemon starts quickly; drop these flags (and
    # add --ckpt) for the real model
    extra = ["--clip-len", "16", "--stride", "8", "--crop-size", "32",
             "--backbone-size", "32", "--pyramid-height", "2",
             "--phase-size", "16", "--chunk", "8", "--capacity", "4"]
    if args.cpu:
        extra.append("--cpu")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO, env.get("PYTHONPATH")) if p)
    client = DaemonClient(extra, cwd=_REPO, env=env)
    try:
        print("ping:", client.request(cmd="ping"))

        # a predict and a live stream interleaved: the daemon predicts on a
        # worker thread, so stream chunks keep flowing; responses carry
        # their "id", and the predict may answer after later feeds
        client.request(cmd="stream_open", stream="cam0")
        client.send(cmd="predict", video=video, id="vid",
                    out_csv=os.path.join(args.out_dir, "preds.csv"))
        rng = np.random.default_rng(0)
        for chunk_idx in range(3):
            crops = rng.uniform(0, 255, (8, 32, 32, 3))
            client.send(cmd="stream_feed", stream="cam0",
                        id=f"chunk{chunk_idx}", data=crops.tolist())
        order = []
        for _ in range(4):                    # 1 predict + 3 feeds
            r = client.read()
            order.append(r.get("id"))
            if r.get("id") == "vid":
                print("predict:", json.dumps(
                    {k: r[k] for k in ("frames", "valence_mean",
                                       "arousal_mean") if k in r}))
            else:
                vals = np.asarray(r["values"])
                print(f"{r.get('id')}: v/a mean = "
                      f"{vals[:, 0].mean():+.3f} / "
                      f"{vals[:, 1].mean():+.3f}")
        print("response order (predict interleaves):", order)

        # many streams in one device step: every feed runs a full
        # [capacity, ...] batch, so one stream_feed_multi costs what one
        # stream_feed does
        client.request(cmd="stream_open", stream="cam1")
        r = client.request(cmd="stream_feed_multi", streams={
            "cam0": rng.uniform(0, 255, (8, 32, 32, 3)).tolist(),
            "cam1": rng.uniform(0, 255, (8, 32, 32, 3)).tolist()})
        for name, vals in sorted(r["values"].items()):
            vals = np.asarray(vals)
            print(f"multi[{name}]: v/a mean = {vals[:, 0].mean():+.3f} / "
                  f"{vals[:, 1].mean():+.3f}")
        for name in ("cam0", "cam1"):
            client.request(cmd="stream_close", stream=name)
        print("shutdown:", client.close())
    finally:
        if client.proc.poll() is None:
            client.proc.kill()
            client.proc.wait()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
