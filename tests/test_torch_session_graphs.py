"""A session's feeds as CUDA graphs: the launch counts a replay adds (on
the CPU) and, on the card (marker ``card``; skipped without CUDA), a
replayed feed against ``streaming.step`` run eagerly. No JAX here, so the
card test runs on the card:
``python -m pytest tests/test_torch_session_graphs.py -m card --noconftest``."""

import numpy as np
import pytest
import torch

from mimamo_tpu_torch import streaming, weights
from mimamo_tpu_torch.config import BackboneSpec, MimamoConfig
from mimamo_tpu_torch.kernels import _build
from mimamo_tpu_torch.runner import Mimamo
from mimamo_tpu_torch.streaming import StreamingSession


def test_replays_count_the_launches_of_their_capture():
    """A CUDA graph's replay adds the launches its capture held to the
    kernels' counts (``kernels._build.count``), and its capture takes its
    own back out: counts add up and come back to where they were."""
    counts = _build.launch_counts()
    kern = next(iter(counts))
    _build.count({kern: 3})
    assert _build.launch_counts() == {**counts, kern: counts[kern] + 3}
    _build.count({kern: -3})
    assert _build.launch_counts() == counts


@pytest.mark.card
@torch.no_grad()
def test_card_feeds_replay_the_eager_step():
    """On the card a feed replays its lane count's CUDA graph: a feed of 2
    of 4 slots and one of every slot give the eager ``step``'s outputs and
    state bit for bit and count one forward's launches; after the weights
    are loaded again the graph is captured anew on the new fold."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: feeds replay CUDA graphs only there")
    cfg = MimamoConfig(backbone=BackboneSpec(dtype="bfloat16"))
    model = Mimamo(cfg, device="cuda")
    model.load_state_dict(weights.init_variables(cfg, 0))
    sess = StreamingSession(model, capacity=4, chunk=16, dtype=np.uint8)
    slots = [sess.add_stream() for _ in range(4)]
    rng = np.random.default_rng(0)
    dev = model.device
    for fed in ([1, 3], slots, [1, 3]):
        frames = {s: rng.integers(0, 256, (16, 112, 112, 3), dtype=np.uint8)
                  for s in fed}
        lanes = next(n for n in sess._lane_counts if n >= len(fed))
        order = sess._lanes(fed, lanes)
        batch = np.zeros((lanes, 16, 112, 112, 3), np.uint8)
        for j, i in enumerate(order[:len(fed)]):
            batch[j] = frames[i]
        want = streaming.step(
            model, torch.from_numpy(batch).to(dev),
            torch.tensor(order, device=dev),
            torch.from_numpy(sess._fresh.copy()).to(dev),
            torch.from_numpy(np.isin(slots, fed)).to(dev),
            sess._gru, sess._context)
        before = _build.launch_counts()
        got = sess.feed(frames)
        after = _build.launch_counts()
        for s in fed:
            np.testing.assert_array_equal(got[s], want[0][s].cpu().numpy())
        assert all(torch.equal(a, b) for a, b in
                   zip((*sess._gru, sess._context), (*want[1], want[2])))
        assert sum(after[k] - before[k] for k in after) > 0
        model.load_state_dict(weights.init_variables(cfg, len(fed)))
    graph = streaming._graphs[model][(4, 16, np.dtype(np.uint8), lanes)]
    assert graph.folded is not model._folded
    sess.feed(frames)
    assert streaming._graphs[model][
        (4, 16, np.dtype(np.uint8), lanes)].folded is model._folded
