"""Crop preprocessing for the two streams, and the sliding-window helpers
(PyTorch).

Counterpart of ``to_grayscale``, ``upscale2x`` and ``for_backbone`` in
``mimamo_tpu/preprocess.py``: BT.601 luma for the micro stream, and the
MatConvNet-style backbone input (bilinear resize of the aligned crop to
the backbone's input, per-channel mean subtraction, no scaling) for the
macro stream. At the exact 2x the runner's path never materializes the
backbone input: the stem kernel forms it on the fly
(``kernels.stem_kernel``), and ``for_backbone`` is the plain reference for
it; at any other ratio ``for_backbone`` is the path.

``pad_short_clip``, ``window_starts``, ``sliding_windows`` and
``merge_window_predictions`` are the window bookkeeping of
``predict_from_crops`` (same file of the JAX package): index math and a
[N, clip_len, 2] -> [T, 2] average, on the host in numpy.

Face crops from source frames (``predict_video``): ``crop_and_resize``
(axis-aligned boxes: per-frame hat-function matrices and two batched
GEMMs, IEEE fp32 whatever the TF32 switches say) and ``warp_similarity``
(similarity-aligned crops: elementwise fp32 coordinates, four gathered
taps per output pixel), both on the frames' device, and
``crop_video_chunked``, which runs either over a whole video in
fixed-size chunks on a given device. The fits that give
``warp_similarity`` its transforms (``similarity_from_eyes``,
``similarity_from_landmarks68``, ``similarity_from_landmarks``) are host
numpy, copied from the JAX package line for line.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Tuple, Union

import numpy as np
import torch

from .config import BackboneSpec

# ITU-R BT.601 luma weights (cv2.cvtColor RGB2GRAY convention).
_LUMA_RGB = (0.299, 0.587, 0.114)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def work_dtype(spec: BackboneSpec) -> torch.dtype:
    return _DTYPES[spec.dtype]


def to_grayscale(frames_rgb: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] RGB -> [..., H, W] BT.601 luma."""
    wts = torch.tensor(_LUMA_RGB, dtype=frames_rgb.dtype,
                       device=frames_rgb.device)
    return frames_rgb @ wts


def _upscale2x_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Exact 2x bilinear upscale (half-pixel centers, edge clamp) along
    ``dim``: sample 2i = 0.25 x[i-1] + 0.75 x[i], sample 2i+1 =
    0.75 x[i] + 0.25 x[i+1]."""
    n = x.shape[dim]
    prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    even = 0.25 * prev + 0.75 * x
    odd = 0.75 * x + 0.25 * nxt
    shape = list(x.shape)
    shape[dim] *= 2
    return torch.stack([even, odd], dim=dim + 1).reshape(shape)


def upscale2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upscale of the (-3, -2) spatial axes of [..., H, W, C]."""
    return _upscale2x_axis(_upscale2x_axis(x, x.dim() - 3), x.dim() - 2)


def for_backbone(crops_rgb: torch.Tensor, spec: BackboneSpec) -> torch.Tensor:
    """[..., H, W, 3] RGB crops (0..255) -> [..., I, I, 3] backbone input
    (I = ``spec.input_size``), mean-subtracted, in the configured channel
    order.

    An fp32 square crop of exactly I / 2 takes the stem kernel's
    arithmetic order: the mean subtracted, then the exact 2x upscale, in
    fp32. Every other input takes the JAX package's order: the cast to the
    work dtype; at the exact 2x the interleave upscale in the work dtype
    (bf16: the input of a bf16 fine-tune, rounded after each operation as
    the JAX package's bf16 chain is), at any other size the matmul-form
    bilinear resize in fp32 (IEEE, :func:`ieee_fp32_matmul`; none when the
    crop is already I x I) cast back to the work dtype; then the channel
    flip and the mean subtraction in the work dtype."""
    h, w = crops_rgb.shape[-3], crops_rgb.shape[-2]
    work = work_dtype(spec)
    exact2x = spec.input_size == 2 * h == 2 * w
    if exact2x and work == torch.float32:
        mean = torch.tensor(spec.mean_rgb, dtype=torch.float32,
                            device=crops_rgb.device)
        x = upscale2x(crops_rgb.to(torch.float32) - mean)
        return x.flip(-1) if spec.channel_order == "bgr" else x
    from .phase import resize_bilinear
    x = crops_rgb.to(work)
    if exact2x:
        x = upscale2x(x)
    elif w != spec.input_size:
        size = (spec.input_size, spec.input_size)
        with ieee_fp32_matmul():
            x = resize_bilinear(x.to(torch.float32).movedim(-1, -3),
                                size).movedim(-3, -1).to(work)
    mean = torch.tensor(spec.mean_rgb, dtype=work, device=x.device)
    if spec.channel_order == "bgr":
        x, mean = x.flip(-1), mean.flip(0)
    return x - mean


def pad_short_clip(crops: Union[np.ndarray, torch.Tensor], clip_len: int):
    """Pad a [T < clip_len, ...] crop sequence by repeating its last crop
    (a static tail contributes ~zero phase differences); callers trim the
    outputs back to the true length. Longer sequences pass through."""
    t = crops.shape[0]
    if t >= clip_len:
        return crops
    if isinstance(crops, np.ndarray):
        return np.concatenate(
            [crops, np.repeat(crops[-1:], clip_len - t, axis=0)])
    return torch.cat(
        [crops, crops[-1:].expand((clip_len - t,) + tuple(crops.shape[1:]))])


def window_starts(t: int, clip_len: int, stride: int) -> np.ndarray:
    """Start frames of the sliding windows over a T-frame sequence; the
    last window is right-aligned so the tail is covered."""
    if t < clip_len:
        raise ValueError(f"sequence length {t} < clip_len {clip_len}")
    starts = list(range(0, t - clip_len + 1, stride))
    if starts[-1] != t - clip_len:
        starts.append(t - clip_len)
    return np.asarray(starts, np.int32)


def sliding_windows(x: Union[np.ndarray, torch.Tensor], clip_len: int,
                    stride: int) -> Tuple[Union[np.ndarray, torch.Tensor],
                                          np.ndarray]:
    """Slice [T, ...] into overlapping [N, clip_len, ...] windows; returns
    (windows, starts), see :func:`window_starts`."""
    starts = window_starts(x.shape[0], clip_len, stride)
    idx = starts[:, None] + np.arange(clip_len)[None, :]
    if isinstance(x, np.ndarray):
        return x[idx], starts
    return x[torch.from_numpy(idx).to(x.device, torch.long)], starts


def merge_window_predictions(preds, starts: np.ndarray,
                             total_len: int) -> np.ndarray:
    """Overlap-average [N, clip_len, D] window outputs back to [T, D], on
    the host (the arrays are tiny and every caller already holds them
    there); accumulates in float64 and returns the input dtype."""
    preds = np.asarray(preds)
    _n, clip_len, d = preds.shape
    idx = (np.asarray(starts)[:, None]
           + np.arange(clip_len)[None, :]).reshape(-1)
    acc = np.zeros((total_len, d), np.float64)
    cnt = np.zeros((total_len, 1), np.float64)
    np.add.at(acc, idx, preds.reshape(-1, d).astype(np.float64))
    np.add.at(cnt, idx, 1.0)
    return (acc / np.maximum(cnt, 1.0)).astype(preds.dtype)


# ieee_fp32_matmul's section: the TF32 switches are process-global, so
# threads that overlap share one section. The first thread in saves the
# caller's switches and sets them to IEEE; the last thread out puts the
# saved ones back.
_IEEE_LOCK = threading.Lock()
_ieee_depth = 0
_ieee_saved = None


def _set_ieee():
    """Switch fp32 matmuls to IEEE; returns what to restore. Whichever of
    PyTorch's two ways the caller used to set the switches is used here
    too, because mixing the two makes later reads of the switches raise."""
    cuda_mm = torch.backends.cuda.matmul
    try:
        legacy = (cuda_mm.allow_tf32, torch.get_float32_matmul_precision())
    except RuntimeError:          # the switches were set by fp32_precision
        prev = cuda_mm.fp32_precision
        cuda_mm.fp32_precision = "ieee"
        return ("fp32_precision", prev)
    torch.set_float32_matmul_precision("highest")
    return ("legacy", legacy)


def _restore(saved) -> None:
    api, prev = saved
    if api == "fp32_precision":
        torch.backends.cuda.matmul.fp32_precision = prev
    else:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])


@contextlib.contextmanager
def ieee_fp32_matmul() -> Iterator[None]:
    """fp32 matmuls inside run in IEEE fp32 on every device, whatever the
    caller's switches say (TF32 would round the operands to 10 mantissa
    bits: a crop's hat weights, and so its 0..255 pixels, by up to ~0.2).

    The switches are process-global, so the section is counted under a
    lock: while any thread is inside, they stay IEEE, and the caller's
    switches come back when the last thread leaves."""
    global _ieee_depth, _ieee_saved
    with _IEEE_LOCK:
        if _ieee_depth == 0:
            _ieee_saved = _set_ieee()
        _ieee_depth += 1
    try:
        yield
    finally:
        with _IEEE_LOCK:
            _ieee_depth -= 1
            if _ieee_depth == 0:
                _restore(_ieee_saved)
                _ieee_saved = None


def _interp_matrix(starts: torch.Tensor, sizes: torch.Tensor, src: int,
                   dst: int) -> torch.Tensor:
    """Per-frame bilinear sampling matrices as a hat function.

    ``starts``, ``sizes``: [T] box start/size in source pixels (fp32, one
    axis); ``src``: source extent; ``dst``: output extent. Returns
    [T, dst, src] weights; row i of frame t samples source position
    ``starts[t] + (i + 0.5) * sizes[t] / dst - 0.5`` with edge clamping."""
    i = torch.arange(dst, dtype=torch.float32, device=starts.device)
    # The divisor is a tensor on the boxes' device: CUDA divides by a
    # Python number as a product with its reciprocal, one ulp off the
    # true division the CPU (and the JAX package) takes, which moves a
    # 720p crop by up to ~0.03 on 0..255.
    step = sizes[:, None] / torch.tensor(float(dst), device=sizes.device)
    pos = starts[:, None] + (i[None, :] + 0.5) * step - 0.5   # [T, dst]
    pos = pos.clamp(0.0, src - 1.0)
    j = torch.arange(src, dtype=torch.float32, device=starts.device)
    return (1.0 - (pos[:, :, None] - j[None, None, :]).abs()).clamp_min(0.0)


def crop_and_resize(frames: torch.Tensor, boxes: torch.Tensor,
                    out_size: int) -> torch.Tensor:
    """[T, H, W, C] frames (uint8 or float) and [T, 4] pixel-space
    (y0, x0, height, width) boxes -> [T, out_size, out_size, C] float32
    crops, bilinear, on the frames' device.

    Two batched GEMMs with the per-frame hat matrices (rows, then
    columns), in IEEE fp32 (:func:`ieee_fp32_matmul`): the weights sit
    between 0 and 1 and the pixels up to 255, so a TF32 product would be
    off by up to ~0.2."""
    _t, h, w, _c = frames.shape
    x = frames.to(torch.float32)
    boxes = boxes.to(device=x.device, dtype=torch.float32)
    ry = _interp_matrix(boxes[:, 0], boxes[:, 2], h, out_size)
    rx = _interp_matrix(boxes[:, 1], boxes[:, 3], w, out_size)
    with ieee_fp32_matmul():
        y = torch.einsum("tph,thwc->tpwc", ry, x)
        return torch.einsum("tqw,tpwc->tpqc", rx, y)


def similarity_from_eyes(eyes: np.ndarray, out_size: int,
                         eye_y: float = 0.38, eye_dx: float = 0.28
                         ) -> np.ndarray:
    """Per-frame similarity transforms from eye landmarks (host side).

    Given ``eyes`` [T, 2, 2] = ((left_y, left_x), (right_y, right_x)) in
    source pixels, returns [T, 2, 3] inverse maps A such that output pixel
    (y, x) samples source position ``A @ (y, x, 1)``, placing the eyes at
    canonical positions (eye_y, 0.5 -/+ eye_dx) * out_size. Rotation +
    scale + translation only (no shear).
    """
    eyes = np.asarray(eyes, np.float64)
    t = eyes.shape[0]
    # canonical eye positions in output pixels
    dst_l = np.asarray([eye_y, 0.5 - eye_dx]) * out_size
    dst_r = np.asarray([eye_y, 0.5 + eye_dx]) * out_size
    dst_vec = dst_r - dst_l
    out = np.empty((t, 2, 3), np.float32)
    for i in range(t):
        src_vec = eyes[i, 1] - eyes[i, 0]
        denom = dst_vec @ dst_vec
        # complex-ratio form of the 2D similarity (y as real, x as imag):
        # c = src_vec / dst_vec with c = a + ib
        a = (src_vec @ dst_vec) / denom
        b = (src_vec[1] * dst_vec[0] - src_vec[0] * dst_vec[1]) / denom
        rot = np.asarray([[a, -b], [b, a]])
        trans = eyes[i, 0] - rot @ dst_l
        out[i, :, :2] = rot
        out[i, :, 2] = trans
    return out


def _umeyama_fit(dst: np.ndarray, src: np.ndarray) -> np.ndarray:
    """Least-squares similarity mapping ``dst`` points onto ``src``.

    Complex-number form of the 2-D Procrustes/Umeyama fit (points as
    y + i*x): minimizes sum |c*d + t - s|^2 over rotation+scale ``c`` and
    translation ``t``. Returns the [2, 3] matrix A with
    A @ (y, x, 1) ~= src — an inverse map in the :func:`warp_similarity`
    convention when ``dst`` is in output pixels.
    """
    d = dst[:, 0] + 1j * dst[:, 1]
    s = src[:, 0] + 1j * src[:, 1]
    dm, sm = d.mean(), s.mean()
    d0, s0 = d - dm, s - sm
    denom = np.real(d0 @ d0.conj())
    if denom < 1e-12:
        raise ValueError("degenerate landmark set (all points coincide)")
    c = (d0.conj() @ s0) / denom
    t = sm - c * dm
    a, b = c.real, c.imag
    return np.asarray([[a, -b, t.real], [b, a, t.imag]], np.float64)


def similarity_from_landmarks68(landmarks: np.ndarray, out_size: int,
                                eye_y: float = 0.38, eye_dx: float = 0.28,
                                template: Optional[np.ndarray] = None,
                                gpa_iters: int = 3,
                                eye_indices: Optional[Tuple[int, int]]
                                = None) -> np.ndarray:
    """Per-frame similarity transforms from dense (68-point) landmarks.

    Given ``landmarks`` [T, K>=3, 2] in (y, x) source pixels:

    1. ``template`` (the canonical shape, [K, 2]) defaults to the
       generalized-Procrustes mean of the video's own landmarks; pass
       OpenFace's PDM mean shape for exact OpenFace framing.
    2. The template is anchored into output pixels by the eye convention
       of :func:`similarity_from_eyes`. For K == 68 the iBUG eye clusters
       define the centers; other K need ``eye_indices=(left, right)`` for
       exact framing (without it, the two extremal-x template points
       stand in, with a UserWarning).
    3. Each frame's transform is the least-squares similarity
       (:func:`_umeyama_fit`) from the anchored template to that frame's
       landmarks — an inverse map for :func:`warp_similarity`.

    Returns [T, 2, 3] float32.
    """
    from .io.openface import eyes_from_landmarks68
    lm = np.asarray(landmarks, np.float64)
    t, k = lm.shape[:2]
    if template is None:
        # generalized Procrustes mean of this video's shapes
        mean = lm[0]
        for _ in range(gpa_iters):
            aligned = np.empty_like(lm)
            for i in range(t):
                a = _umeyama_fit(lm[i], mean)   # frame -> mean space
                aligned[i] = lm[i] @ a[:, :2].T + a[:, 2]
            mean = aligned.mean(axis=0)
        template = mean
    template = np.asarray(template, np.float64)
    if template.shape != (k, 2):
        raise ValueError(f"template shape {template.shape} != {(k, 2)}")

    # anchor the template into output pixels via the eye convention
    if eye_indices is not None:
        eyes = np.stack([template[eye_indices[0]],
                         template[eye_indices[1]]])
    elif k == 68:
        eyes = eyes_from_landmarks68(template[None])[0]
    else:
        # Generic K-point sets: no eye semantics are known, so the two
        # extremal-x template points stand in for eye centers.
        import warnings
        warnings.warn(
            f"{k}-point landmark set: anchoring the crop by the two "
            f"extremal-x template points as pseudo-eyes; pass "
            f"eye_indices=(left, right) for exact eye-convention "
            f"framing", stacklevel=2)
        order = np.argsort(template[:, 1])
        eyes = np.stack([template[order[0]], template[order[-1]]])
    a_m = similarity_from_eyes(eyes[None].astype(np.float32), out_size,
                               eye_y=eye_y, eye_dx=eye_dx)[0]
    # invert A_m (out px -> template space) to place template in out px
    rot = np.asarray(a_m[:, :2], np.float64)
    inv = np.linalg.inv(rot)
    anchored = (template - a_m[:, 2]) @ inv.T

    out = np.empty((t, 2, 3), np.float32)
    for i in range(t):
        out[i] = _umeyama_fit(anchored, lm[i]).astype(np.float32)
    return out


def similarity_from_landmarks(landmarks: np.ndarray, out_size: int,
                              **kwargs) -> np.ndarray:
    """Shape-dispatching alignment: [T, 2, 2] eye pairs go through the
    2-point fit, [T, K>=3, 2] dense sets (e.g. OpenFace 68) through the
    Procrustes fit."""
    landmarks = np.asarray(landmarks)
    if landmarks.ndim != 3 or landmarks.shape[-1] != 2:
        raise ValueError(
            f"landmarks must be [T, K, 2], got {landmarks.shape}")
    if landmarks.shape[1] == 2:
        return similarity_from_eyes(landmarks, out_size, **kwargs)
    return similarity_from_landmarks68(landmarks, out_size, **kwargs)


def warp_similarity(frames: torch.Tensor, transforms: torch.Tensor,
                    out_size: int) -> torch.Tensor:
    """[T, H, W, C] frames and [T, 2, 3] inverse maps (see
    :func:`similarity_from_eyes`) -> [T, out_size, out_size, C] float32
    aligned crops (edge-clamped), on the frames' device.

    Rotation makes the sampling non-separable, so each output pixel
    gathers four taps from the flattened H*W axis. The coordinates are
    elementwise fp32 products and sums, never a matmul: a K = 3 coordinate
    product under TF32 (or bf16, as on the TPU) shifts the sampling
    positions by a pixel or more at HD-scale offsets.
    """
    t, h, w, c = frames.shape
    x = frames.to(torch.float32)
    grid = torch.arange(out_size, dtype=torch.float32, device=x.device) + 0.5
    grid_y = grid[:, None].expand(out_size, out_size)
    grid_x = grid[None, :].expand(out_size, out_size)
    a = transforms.to(device=x.device, dtype=torch.float32)[:, None, None]
    src = (a[..., 0] * grid_y[None, :, :, None]
           + a[..., 1] * grid_x[None, :, :, None]
           + a[..., 2]) - 0.5                           # [T, S, S, 2]
    sy = src[..., 0].clamp(0.0, h - 1.0)
    sx = src[..., 1].clamp(0.0, w - 1.0)
    y0 = sy.floor()
    x0 = sx.floor()
    fy, fx = (sy - y0)[..., None], (sx - x0)[..., None]
    y0 = y0.long()
    x0 = x0.long()
    y1 = (y0 + 1).clamp_max(h - 1)
    x1 = (x0 + 1).clamp_max(w - 1)

    flat = x.reshape(t, h * w, c)

    def tap(yy, xx):                                    # [T, S, S, C]
        idx = (yy * w + xx).reshape(t, out_size * out_size, 1)
        return torch.gather(flat, 1, idx.expand(-1, -1, c)).reshape(
            t, out_size, out_size, c)

    top = tap(y0, x0) * (1 - fx) + tap(y0, x1) * fx
    bot = tap(y1, x0) * (1 - fx) + tap(y1, x1) * fx
    return top * (1 - fy) + bot * fy


@torch.no_grad()
def crop_video_chunked(frames_rgb: Union[np.ndarray, torch.Tensor],
                       params: np.ndarray, crop_size: int, device,
                       align: bool = False, chunk: int = 64) -> torch.Tensor:
    """Source frames -> [T, crop_size, crop_size, 3] float32 crops on
    ``device``, ``chunk`` frames at a time: a decoded video at source
    resolution need not fit the card (60 s of 1080p is ~37 GB as float32).

    ``params``: [T, 4] boxes (:func:`crop_and_resize`), or [T, 2, 3]
    similarity transforms with ``align=True`` (:func:`warp_similarity`).
    Frames cross to the device in their own dtype (uint8 from the decoder)
    and are cast there. The tail chunk is padded by repeating its last
    frame and params and trimmed after the crop, so every chunk has one
    shape."""
    crop = warp_similarity if align else crop_and_resize
    t = frames_rgb.shape[0]
    if t == 0:
        raise ValueError("crop_video_chunked: empty video "
                         "(0 decoded frames)")
    pieces = []
    for s in range(0, t, chunk):
        f = torch.as_tensor(frames_rgb[s:s + chunk]).to(device)
        p = torch.as_tensor(np.asarray(params[s:s + chunk], np.float32)
                            ).to(device)
        n = f.shape[0]
        out = crop(pad_short_clip(f, chunk), pad_short_clip(p, chunk),
                   crop_size)
        pieces.append(out[:n] if n < chunk else out)
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)
