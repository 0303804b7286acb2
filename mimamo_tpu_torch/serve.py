"""Long-running serving daemon: JSON-lines protocol over stdin/stdout.

Counterpart of ``mimamo_tpu/serve.py``, with the same protocol. The
daemon loads the weights once, builds the kernels and folds the backbone
once, then serves an unbounded sequence of requests. JSON lines over
stdin/stdout keep it transport-agnostic.

Protocol (one JSON object per line; responses echo ``id`` if present):

  {"cmd": "ping"}
      -> {"ok": true, "capacity": C, "active_streams": {...}, ...}
  {"cmd": "predict", "video": PATH | "crops": PATH (precomputed
   aligned crops: packed .npy or image dir; exactly one of the two),
   "align"?: bool, "landmarks"?: PATH, "boxes"?: PATH (video only),
   "max_frames"?: N, "smooth"?: K, "out_csv"?: PATH, "series"?: bool}
      -> {"ok": true, "frames": N, "valence_mean": ..,
          "arousal_mean": .., "series"?: [[v, a], ...]}
  {"cmd": "stream_open", "stream": NAME}
      -> {"ok": true, "slot": i}          # claims a StreamingSession slot
  {"cmd": "stream_feed", "stream": NAME, "crops": PATH.npy | "data": [...]}
      -> {"ok": true, "values": [[v, a], ...]}   # one fixed-size chunk
  {"cmd": "stream_feed_multi", "streams": {NAME: PATH.npy | [...], ...}}
      -> {"ok": true, "values": {NAME: [[v, a], ...]}}  # one forward
  {"cmd": "stream_close", "stream": NAME}
      -> {"ok": true}
  {"cmd": "shutdown"}
      -> {"ok": true, "shutdown": true}    # then the loop exits

Errors never kill the daemon: a failed request returns
{"ok": false, "error": "..."} and the loop goes on.

Concurrency: ``predict`` (a whole video's decode and inference) runs on
one worker thread, so stream commands keep being answered while it is in
flight; its response may come after responses to later requests
(correlate by ``id``). All other commands are answered in request order;
``run(predict_async=False)`` puts ``predict`` back in that order. Both
threads launch on the current CUDA stream, so on the card a feed's
forward can wait behind a predict's queued work.

Trust model: requests name filesystem paths ("video", "crops", "boxes",
"landmarks", "out_csv"), so the client is trusted by default. For
untrusted callers construct the Server with ``allowed_root=DIR`` (CLI:
``--allowed-root``): every request path must then resolve (symlinks
included) under that directory.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, TextIO

import numpy as np

from .api import MimamoAPI
from .config import MimamoConfig
from .streaming import StreamingSession


class Server:
    """Request dispatcher; transport-independent (see :func:`run`).

    The weights are ``state_dict`` (the port's schema), else the latest
    step of a port checkpoint directory, else random ones from seed 0;
    ``device`` as in ``MimamoAPI`` (the card unless the CPU is asked
    for)."""

    def __init__(self, config: Optional[MimamoConfig] = None,
                 state_dict=None, checkpoint_dir: Optional[str] = None,
                 capacity: int = 8, chunk: int = 16,
                 stream_dtype=np.float32, warmup: bool = False,
                 allowed_root: Optional[str] = None, device=None):
        self.api = MimamoAPI(config=config, state_dict=state_dict,
                             device=device, checkpoint_dir=checkpoint_dir)
        self.session = StreamingSession(self.api.model, capacity=capacity,
                                        chunk=chunk, dtype=stream_dtype)
        self._streams: Dict[str, int] = {}   # user name -> slot
        self._t0 = time.time()
        self._served = 0
        self._lock = threading.Lock()        # counter; 2 handle() threads
        self.allowed_root = (os.path.realpath(allowed_root)
                             if allowed_root else None)
        if warmup:
            self._warmup()

    def _check_path(self, path: str, kind: str) -> str:
        """Enforce the opt-in allowed_root restriction (module docstring)."""
        if self.allowed_root is not None:
            rp = os.path.realpath(str(path))
            root = self.allowed_root
            if rp != root and not rp.startswith(root + os.sep):
                raise ValueError(
                    f"{kind} path {path!r} resolves outside the "
                    f"allowed root {root!r}")
        return path

    def _warmup(self) -> None:
        """One feed before the first request: it builds the kernels and
        folds the backbone on this thread."""
        cfg = self.api.model.config.clip
        slot = self.session.add_stream()
        try:
            z = np.zeros((self.session.chunk, cfg.crop_size,
                          cfg.crop_size, 3), self.session.dtype)
            self.session.feed({slot: z})
        finally:
            self.session.remove_stream(slot)

    # -- dispatch -----------------------------------------------------------

    def handle(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """One request -> one response dict (never raises)."""
        rid = req.get("id")
        try:
            cmd = req.get("cmd")
            fn = getattr(self, f"_cmd_{cmd}", None)
            if not isinstance(cmd, str) or fn is None:
                raise ValueError(f"unknown cmd {cmd!r}")
            resp = fn(req)
            resp.setdefault("ok", True)
        except Exception as e:  # noqa: BLE001 — daemon must survive
            resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        if rid is not None:
            resp["id"] = rid
        with self._lock:
            self._served += 1
        return resp

    def _cmd_ping(self, req) -> Dict[str, Any]:
        return {"capacity": self.session.capacity,
                "chunk": self.session.chunk,
                "active_streams": dict(self._streams),
                "served": self._served,
                "uptime_sec": round(time.time() - self._t0, 3)}

    def _cmd_predict(self, req) -> Dict[str, Any]:
        for kind in ("video", "crops", "out_csv", "boxes", "landmarks"):
            if req.get(kind):
                self._check_path(req[kind], kind)
        if bool(req.get("video")) == bool(req.get("crops")):
            raise ValueError(
                "predict takes exactly one of 'video' / 'crops'")
        if req.get("crops"):
            # precomputed aligned crops, as cli predict --crops
            if req.get("align") or req.get("boxes") or \
                    req.get("landmarks"):
                raise ValueError("'crops' are already aligned — "
                                 "align/boxes/landmarks do not apply")
            series = self.api.predict_crops(
                req["crops"], out_csv=req.get("out_csv"),
                max_frames=req.get("max_frames"),
                smooth=int(req.get("smooth", 1)))
        else:
            series = self.api.predict(
                req["video"], out_csv=req.get("out_csv"),
                boxes_path=req.get("boxes"),
                max_frames=req.get("max_frames"),
                align=bool(req.get("align", False)),
                landmarks_path=req.get("landmarks"),
                smooth=int(req.get("smooth", 1)))
        resp = {"frames": int(series.shape[0]),
                "valence_mean": float(series[:, 0].mean()),
                "arousal_mean": float(series[:, 1].mean())}
        if req.get("out_csv"):
            resp["out_csv"] = req["out_csv"]
        if req.get("series"):
            resp["series"] = [[round(float(v), 6), round(float(a), 6)]
                              for v, a in series]
        return resp

    def _cmd_stream_open(self, req) -> Dict[str, Any]:
        name = req["stream"]
        if name in self._streams:
            raise ValueError(f"stream {name!r} already open")
        slot = self.session.add_stream()
        self._streams[name] = slot
        return {"slot": slot}

    def _load_chunk(self, source) -> np.ndarray:
        """Chunk from an npy path (str) or an inline array (list)."""
        if isinstance(source, str):
            frames = np.load(self._check_path(source, "crops"))
        else:
            frames = np.asarray(source, np.float32)
        if (np.issubdtype(self.session.dtype, np.integer)
                and np.issubdtype(frames.dtype, np.floating)):
            # round, don't truncate: a uint8 session must match a float
            # session for clients sending non-integral pixel values
            frames = np.clip(np.rint(frames), 0, 255)
        return frames.astype(self.session.dtype)

    @staticmethod
    def _fmt_values(vals) -> list:
        return [[round(float(v), 6), round(float(a), 6)] for v, a in vals]

    def _cmd_stream_feed(self, req) -> Dict[str, Any]:
        name = req["stream"]
        if name not in self._streams:
            raise ValueError(f"stream {name!r} is not open")
        if "crops" in req:
            frames = self._load_chunk(req["crops"])
        elif "data" in req:
            frames = self._load_chunk(req["data"])
        else:
            raise ValueError("stream_feed needs 'crops' (npy path) "
                             "or 'data' (inline array)")
        out = self.session.feed({self._streams[name]: frames})
        return {"values": self._fmt_values(out[self._streams[name]])}

    def _cmd_stream_feed_multi(self, req) -> Dict[str, Any]:
        """Advance many streams in one forward: ``{"streams": {name:
        npy-path | inline array, ...}}`` -> ``{"values": {name: [[v, a],
        ...]}}``. The session always runs all its slots, so N
        ``stream_feed`` requests cost N forwards and this costs one."""
        streams = req.get("streams")
        if not isinstance(streams, dict) or not streams:
            raise ValueError("stream_feed_multi needs a non-empty "
                             "'streams' {name: chunk} mapping")
        missing = [n for n in streams if n not in self._streams]
        if missing:
            raise ValueError(f"streams not open: {missing}")
        feed = {self._streams[n]: self._load_chunk(src)
                for n, src in streams.items()}
        out = self.session.feed(feed)
        return {"values": {n: self._fmt_values(out[self._streams[n]])
                           for n in streams}}

    def _cmd_stream_close(self, req) -> Dict[str, Any]:
        name = req["stream"]
        if name not in self._streams:
            raise ValueError(f"stream {name!r} is not open")
        self.session.remove_stream(self._streams.pop(name))
        return {}

    def _cmd_shutdown(self, req) -> Dict[str, Any]:
        return {"shutdown": True}


def run(server: Server, fin: Optional[TextIO] = None,
        fout: Optional[TextIO] = None, predict_async: bool = True) -> None:
    """Blocking serve loop: read JSON lines from ``fin``, write responses
    to ``fout`` (defaults: stdin/stdout). Exits on EOF or shutdown.

    With ``predict_async`` (default), ``predict`` requests run on one
    worker thread (one after another) while this thread keeps serving the
    other commands; a predict's response is written when it is done.
    Predicts in flight are drained before the loop returns.
    ``predict_async=False`` answers every request in order."""
    fin = fin or sys.stdin
    fout = fout or sys.stdout
    wlock = threading.Lock()

    def emit(resp: Dict[str, Any]) -> None:
        with wlock:
            fout.write(json.dumps(resp) + "\n")
            fout.flush()

    pool = ThreadPoolExecutor(max_workers=1) if predict_async else None
    try:
        for line in fin:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
                if not isinstance(req, dict):
                    raise ValueError("request must be a JSON object")
            except ValueError as e:
                emit({"ok": False, "error": f"bad request line: {e}"})
                continue
            if pool is not None and req.get("cmd") == "predict":
                # handle() never raises, but emit() can (a broken pipe, a
                # value json cannot write): a lost worker exception would
                # leave the client waiting on its id, so report it
                def _done(fut, rid=req.get("id")):
                    exc = fut.exception()
                    if exc is None:
                        return
                    print(f"serve: async predict response failed: "
                          f"{type(exc).__name__}: {exc}",
                          file=sys.stderr, flush=True)
                    try:
                        err = {"ok": False,
                               "error": f"response write failed: {exc}"}
                        if rid is not None:
                            err["id"] = rid
                        emit(err)
                    except Exception:  # noqa: BLE001 - pipe truly dead
                        pass
                pool.submit(
                    lambda r=req: emit(server.handle(r))
                ).add_done_callback(_done)
                continue
            resp = server.handle(req)
            emit(resp)
            if resp.get("shutdown"):
                break
    finally:
        if pool is not None:
            pool.shutdown(wait=True)   # drain in-flight predicts
