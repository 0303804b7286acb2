"""Plain fp32 reference of MIMAMO-Net, for deciding whether a run is correct.

Written from the published model (Deng et al., "MIMAMO Net: Integrating
Micro- and Macro-motion for Video Emotion Recognition", AAAI 2020,
arXiv:1911.09784) and from the configuration files under
``benchmark/configs/``, in plain PyTorch. It imports nothing of the
program and takes nothing the program made: it reads the configuration as
a dict and the weights as the ``state_dict`` that the benchmark made, and
it folds BatchNorm, builds its pyramid masks and runs its GRUs itself.

The pieces, as the configuration states them:

* micro stream: BT.601 luma (an fma chain, ``addcmul``), the complex
  steerable pyramid as masks on the fftshifted spectrum (a band of scale
  s on the central H/2^s x W/2^s box, raised-cosine rings one octave wide,
  steering windows cos^(K-1), the (-i)^(K-1) analytic factor), the phase
  difference ``angle(c_t conj(c_{t-1}))`` of consecutive frames and a
  bilinear resize (``F.interpolate``) to P x P, channels c = s K + k;
* macro stream: the crop less the channel means, a 2x bilinear upscale to
  the backbone input, ResNet-50 (stride in the first 1x1 conv of a stage,
  the Caffe placement of FER+) with BatchNorm folded, pool5;
* temporal model: a two-conv micro CNN with BatchNorm, a projection of
  the 2048-d embedding, one GRU per stream (a hand-written cell, gates
  r, z, n as in ``torch.nn.GRU``), the fusion layer and the head.

Everything runs in fp32 with TF32 off unless another precision is asked
for: ``low="bf16"``, the backbone in bf16 as the configuration states it
for serving (the yardstick the program's own rounding is measured in),
or the controls ``low="fp8"`` and ``low="tf32"``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

LUMA_RGB = (0.299, 0.587, 0.114)
STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))   # ResNet-50: blocks, width
BN_EPS = 1e-5
FP8_MAX = 448.0                                    # float8_e4m3fn


# -- the state_dict's schema ---------------------------------------------------

def schema(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """(name, shape, kind, fan_in) of every tensor of the model's
    ``state_dict``. ``kind``: conv, bn_weight, bn_bias, bn_mean, bn_var,
    bn_count, linear, gru."""
    t, b = cfg["temporal"], cfg["backbone"]
    out: List[Tuple[str, Tuple[int, ...], str, int]] = []

    def conv(name, o, i, k):
        out.append((f"{name}.weight", (o, i, k, k), "conv", i * k * k))

    def bn(name, c):
        for part, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                           ("running_mean", "bn_mean"),
                           ("running_var", "bn_var")):
            out.append((f"{name}.{part}", (c,), kind, c))
        out.append((f"{name}.num_batches_tracked", (), "bn_count", 0))

    def linear(name, o, i):
        out.append((f"{name}.weight", (o, i), "linear", i))
        out.append((f"{name}.bias", (o,), "linear", i))

    def gru(name, i, h):
        for part, shape in (("weight_ih_l0", (3 * h, i)),
                            ("weight_hh_l0", (3 * h, h)),
                            ("bias_ih_l0", (3 * h,)),
                            ("bias_hh_l0", (3 * h,))):
            out.append((f"{name}.{part}", shape, "gru", h))

    conv("backbone.conv1", 64, 3, 7)
    bn("backbone.bn1", 64)
    inplanes = 64
    for i, (blocks, width) in enumerate(STAGES):
        for j in range(blocks):
            p = f"backbone.layer{i + 1}.{j}"
            conv(f"{p}.conv1", width, inplanes, 1)
            bn(f"{p}.bn1", width)
            conv(f"{p}.conv2", width, width, 3)
            bn(f"{p}.bn2", width)
            conv(f"{p}.conv3", 4 * width, width, 1)
            bn(f"{p}.bn3", 4 * width)
            if j == 0:
                conv(f"{p}.downsample.0", 4 * width, inplanes, 1)
                bn(f"{p}.downsample.1", 4 * width)
            inplanes = 4 * width
    linear("backbone.fc", b["num_classes"], b["feature_dim"])
    c = cfg["pyramid"]["height"] * cfg["pyramid"]["orientations"]
    p = cfg["phase"]["phase_size"]
    for i, feats in enumerate(t["micro_cnn_features"]):
        conv(f"temporal.micro_cnn.conv{i + 1}", feats, c, 3)
        bn(f"temporal.micro_cnn.bn{i + 1}", feats)
        c, p = feats, p // 2
    linear("temporal.micro_cnn.fc", t["micro_embed_dim"], c * p * p)
    gru("temporal.gru_micro", t["micro_embed_dim"], t["gru_hidden"])
    linear("temporal.macro_proj", t["macro_embed_dim"], b["feature_dim"])
    gru("temporal.gru_macro", t["macro_embed_dim"], t["gru_hidden"])
    linear("temporal.fusion", t["fusion_hidden"], 2 * t["gru_hidden"])
    linear("temporal.head", t["num_outputs"], t["fusion_hidden"])
    return out


# The keys of each section of a configuration that this reference
# computes (``epochs``, ``seed``, ``batch_size`` and ``remat_backbone``
# leave its numbers as they are; ``fps`` is metadata).
KEYS = {
    "pyramid": {"height", "orientations", "input_size", "complex_factor"},
    "phase": {"phase_size", "amplitude_weighting"},
    "backbone": {"input_size", "feature_dim", "num_classes", "mean_rgb",
                 "channel_order", "dtype", "appearance_stride"},
    "temporal": {"streams", "micro_cnn_features", "micro_embed_dim",
                 "macro_embed_dim", "gru_hidden", "gru_layers",
                 "fusion_hidden", "num_outputs", "output_activation",
                 "snippet_len"},
    "clip": {"clip_len", "stride", "crop_size", "fps"},
    "train": {"learning_rate", "weight_decay", "lr_schedule", "warmup_steps",
              "batch_size", "epochs", "loss", "mse_weight", "augment",
              "brightness_jitter", "loss_axis", "seed", "freeze_backbone",
              "remat_backbone"},
}


def check_supported(cfg: dict) -> None:
    """The reference computes the variant the benchmark's configurations
    state: both streams, one GRU layer, no snippet pooling, every frame
    through the backbone at exactly twice the crop; and no key of a
    section that it does not know (``KEYS``): a configuration with one is
    another model, and names a reference of its own."""
    for section, known in KEYS.items():
        unknown = sorted(set(cfg.get(section, {})) - known)
        if unknown:
            raise ValueError(
                f"{section}: the reference 'mimamo' does not compute "
                f"{unknown}; name a reference of the configuration's own "
                f"(\"reference\": \"<module>\" in its file, a module of "
                f"benchmark/reference/)")
    t, b = cfg["temporal"], cfg["backbone"]
    size = cfg["pyramid"]["input_size"]
    if (t["streams"] != "both" or t["gru_layers"] != 1
            or t["snippet_len"] != 1 or b["appearance_stride"] != 1
            or b["input_size"] != 2 * size[0] or size[0] != size[1]
            or cfg["clip"]["crop_size"] != size[0]):
        raise ValueError("the reference computes both streams, one GRU "
                         "layer, no snippets, stride 1 and a backbone input "
                         "of twice a square crop")


# -- precision -----------------------------------------------------------------

@contextlib.contextmanager
def matmul_precision(tf32: bool) -> Iterator[None]:
    """fp32 matmuls and convs in IEEE fp32 (``tf32=False``) or in TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude onto the format's largest), back in fp32."""
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


# -- micro stream --------------------------------------------------------------

def grey(frames_rgb: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] RGB (0..255) -> [..., H, W] BT.601 luma,
    fma(b, w_b, fma(g, w_g, r w_r))."""
    x = frames_rgb.to(torch.float32)
    w = torch.tensor(LUMA_RGB, dtype=torch.float32, device=x.device)
    r, g, b = x.unbind(-1)
    return torch.addcmul(torch.addcmul(r * w[0], g, w[1]), b, w[2])


def _lowpass(log_rad: np.ndarray, log_r0: float) -> np.ndarray:
    t = np.clip(log_rad - log_r0, -1.0, 0.0)
    ramp = np.cos(np.pi / 2.0 * (t + 1.0))
    return np.where(log_rad - log_r0 <= -1.0, 1.0,
                    np.where(log_rad - log_r0 >= 0.0, 0.0, ramp))


def band_masks(cfg: dict) -> List[np.ndarray]:
    """[K, H/2^s, W/2^s] complex64 oriented band masks of each scale s, on
    the central box of the fftshifted spectrum. Radius normalised so that
    the spectrum's edge midpoint is pi (log2 radius 0 there); DC takes the
    radius of its left neighbour."""
    pyr = cfg["pyramid"]
    h, w = pyr["input_size"]
    scales, k = pyr["height"], pyr["orientations"]
    fy = (np.arange(h) - h // 2) / (h / 2.0)
    fx = (np.arange(w) - w // 2) / (w / 2.0)
    xr, yr = np.meshgrid(fx, fy)
    angle = np.arctan2(yr, xr)
    rad = np.sqrt(xr * xr + yr * yr)
    rad[h // 2, w // 2] = rad[h // 2, w // 2 - 1]
    log_rad = np.log2(rad)
    order = k - 1
    alpha = (2.0 ** order) * math.factorial(order) / math.sqrt(
        k * math.factorial(2 * order))
    steer = [np.where(np.cos(angle - np.pi * j / k) > 0.0,
                      alpha * np.abs(np.cos(angle - np.pi * j / k)) ** order,
                      0.0) for j in range(k)]
    factor = (-1j) ** order if pyr["complex_factor"] else 1.0 + 0.0j
    lo = _lowpass(log_rad, 0.0)
    masks = []
    for s in range(scales):
        hi = np.sqrt(np.maximum(0.0, 1.0 - _lowpass(log_rad, -(s + 1.0)) ** 2))
        ring = lo * hi
        hs, ws = h >> s, w >> s
        y0, x0 = h // 2 - hs // 2, w // 2 - ws // 2
        box = (slice(y0, y0 + hs), slice(x0, x0 + ws))
        masks.append((np.stack([2.0 * ring[box] * g[box] for g in steer])
                      * factor).astype(np.complex64))
        lo = lo * _lowpass(log_rad, -(s + 1.0))
    return masks


def _centre(x: torch.Tensor, hs: int, ws: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    y0, x0 = h // 2 - hs // 2, w // 2 - ws // 2
    return x[..., y0:y0 + hs, x0:x0 + ws]


# -- the model -------------------------------------------------------------------

class Reference:
    """The model of one configuration with one set of weights, on one
    device. ``low``: None (fp32, TF32 off), ``"bf16"`` (the backbone's
    convs, activations, bias, relu and residual adds in bf16, pool5 summed
    in fp32), ``"fp8"`` (the backbone's convs on float8 inputs and
    weights) or ``"tf32"`` (every fp32 matmul and conv in TF32)."""

    check_supported = staticmethod(check_supported)

    def __init__(self, cfg: dict, state: Dict[str, torch.Tensor],
                 device, low: Optional[str] = None):
        self.check_supported(cfg)
        if low not in (None, "bf16", "fp8", "tf32"):
            raise ValueError(f"unknown precision {low!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.low = low
        self.p = {k: v.detach().to(self.device, torch.float32)
                  for k, v in state.items()
                  if not k.endswith("num_batches_tracked")}
        self.masks = [torch.from_numpy(m).to(self.device)
                      for m in band_masks(cfg)]
        self.mean = torch.tensor(cfg["backbone"]["mean_rgb"],
                                 dtype=torch.float32, device=self.device)
        self.convs = self._fold()

    def precision(self):
        return matmul_precision(self.low == "tf32")

    def stated(self) -> "Reference":
        """This model computed plainly in the precision its configuration
        states for the backbone (bf16 for serving)."""
        if self.cfg["backbone"]["dtype"] != "bfloat16":
            raise ValueError("the stated-precision yardstick is for a bf16 "
                             "backbone")
        return type(self)(self.cfg, self.p, self.device, low="bf16")

    # backbone ----------------------------------------------------------------

    def _fold(self) -> Dict[str, Tuple[torch.Tensor, torch.Tensor, int, int]]:
        """conv name -> (folded weight, folded bias, stride, padding)."""
        def fold(conv, bn, stride, pad):
            s = self.p[f"{bn}.weight"] / torch.sqrt(
                self.p[f"{bn}.running_var"] + BN_EPS)
            return (self.p[f"{conv}.weight"] * s[:, None, None, None],
                    self.p[f"{bn}.bias"] - self.p[f"{bn}.running_mean"] * s,
                    stride, pad)

        out = {"conv1": fold("backbone.conv1", "backbone.bn1", 2, 3)}
        for i, (blocks, _) in enumerate(STAGES):
            for j in range(blocks):
                p = f"backbone.layer{i + 1}.{j}"
                stride = 2 if i > 0 and j == 0 else 1
                out[f"{p}.conv1"] = fold(f"{p}.conv1", f"{p}.bn1", stride, 0)
                out[f"{p}.conv2"] = fold(f"{p}.conv2", f"{p}.bn2", 1, 1)
                out[f"{p}.conv3"] = fold(f"{p}.conv3", f"{p}.bn3", 1, 0)
                if j == 0:
                    out[f"{p}.downsample"] = fold(f"{p}.downsample.0",
                                                  f"{p}.downsample.1",
                                                  stride, 0)
        return out

    def _conv(self, x: torch.Tensor, name: str) -> torch.Tensor:
        w, b, stride, pad = self.convs[name]
        if self.low == "fp8":
            x, w = fp8(x), fp8(w)
        return F.conv2d(x, w.to(x.dtype), b.to(x.dtype), stride=stride,
                        padding=pad)

    def embed(self, crops: torch.Tensor, block: int = 96) -> torch.Tensor:
        """[N, S, S, 3] crops (0..255) -> [N, 2048] pool5 embeddings."""
        outs = []
        size = self.cfg["backbone"]["input_size"]
        bgr = self.cfg["backbone"]["channel_order"] == "bgr"
        with torch.no_grad(), self.precision():
            for i in range(0, crops.shape[0], block):
                x = crops[i:i + block].to(self.device, torch.float32) - self.mean
                if bgr:
                    x = x.flip(-1)
                x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                                  mode="bilinear", align_corners=False)
                if self.low == "bf16":
                    x = x.to(torch.bfloat16)
                x = F.max_pool2d(F.relu(self._conv(x, "conv1")), 3, 2, 1)
                for s, (blocks, _) in enumerate(STAGES):
                    for j in range(blocks):
                        p = f"backbone.layer{s + 1}.{j}"
                        res = (self._conv(x, f"{p}.downsample") if j == 0
                               else x)
                        y = F.relu(self._conv(x, f"{p}.conv1"))
                        y = F.relu(self._conv(y, f"{p}.conv2"))
                        x = F.relu(self._conv(y, f"{p}.conv3") + res)
                outs.append(x.float().mean(dim=(2, 3)).to(x.dtype).float())
        return torch.cat(outs)

    # micro stream --------------------------------------------------------------

    def phase(self, frames_rgb: torch.Tensor, block: int = 96) -> torch.Tensor:
        """[T, S, S, 3] consecutive frames -> [T-1, S*K, P, P] phase
        differences of each pair, in blocks of frames."""
        pyr, size = self.cfg["pyramid"], self.cfg["phase"]["phase_size"]
        if self.cfg["phase"]["amplitude_weighting"]:
            raise ValueError("the reference computes unweighted phase")
        outs = []
        t = frames_rgb.shape[0]
        with torch.no_grad(), self.precision():
            for i in range(0, t - 1, block):
                g = grey(frames_rgb[i:min(i + block + 1, t)].to(self.device))
                spec = torch.fft.fftshift(torch.fft.fft2(
                    g.to(torch.complex64)), dim=(-2, -1))
                maps = []
                for mask in self.masks[:pyr["height"]]:
                    k, hs, ws = mask.shape
                    band = torch.fft.ifft2(torch.fft.ifftshift(
                        _centre(spec, hs, ws)[:, None] * mask, dim=(-2, -1)))
                    prod = band[1:] * band[:-1].conj()
                    dphi = torch.atan2(prod.imag, prod.real)
                    maps.append(F.interpolate(
                        dphi.reshape(-1, 1, hs, ws), size=(size, size),
                        mode="bilinear", align_corners=False
                    ).reshape(-1, k, size, size))
                outs.append(torch.cat(maps, dim=1))
        return torch.cat(outs)

    # temporal model ----------------------------------------------------------

    def _bn(self, x: torch.Tensor, params, name: str, train: bool
            ) -> torch.Tensor:
        w, b = params[f"{name}.weight"], params[f"{name}.bias"]
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = ((x - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
        else:
            mean, var = self.p[f"{name}.running_mean"], self.p[
                f"{name}.running_var"]
        return ((x - mean[None, :, None, None])
                * torch.rsqrt(var + BN_EPS)[None, :, None, None]
                * w[None, :, None, None] + b[None, :, None, None])

    def micro_embed(self, stacks: torch.Tensor, params, train: bool = False
                    ) -> torch.Tensor:
        """[N, C, P, P] phase stacks -> [N, micro_embed_dim]."""
        x = stacks
        for i in range(len(self.cfg["temporal"]["micro_cnn_features"])):
            name = f"temporal.micro_cnn.conv{i + 1}"
            x = F.conv2d(x, params[f"{name}.weight"], padding=1)
            x = self._bn(x, params, f"temporal.micro_cnn.bn{i + 1}", train)
            x = F.max_pool2d(F.relu(x), 2)
        return F.linear(x.flatten(1), params["temporal.micro_cnn.fc.weight"],
                        params["temporal.micro_cnn.fc.bias"])

    @staticmethod
    def gru(xs: torch.Tensor, params, name: str,
            h: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, T, D] -> [B, T, H] hidden states, from ``h`` (zeros)."""
        w_ih, w_hh = params[f"{name}.weight_ih_l0"], params[f"{name}.weight_hh_l0"]
        b_ih, b_hh = params[f"{name}.bias_ih_l0"], params[f"{name}.bias_hh_l0"]
        n = w_hh.shape[1]
        gi = F.linear(xs, w_ih, b_ih)
        if h is None:
            h = xs.new_zeros(xs.shape[0], n)
        ys = []
        for t in range(xs.shape[1]):
            gh = F.linear(h, w_hh, b_hh)
            r = torch.sigmoid(gi[:, t, :n] + gh[:, :n])
            z = torch.sigmoid(gi[:, t, n:2 * n] + gh[:, n:2 * n])
            c = torch.tanh(gi[:, t, 2 * n:] + r * gh[:, 2 * n:])
            h = (1 - z) * c + z * h
            ys.append(h)
        return torch.stack(ys, dim=1)

    def temporal(self, micro: torch.Tensor, emb: torch.Tensor,
                 params=None) -> torch.Tensor:
        """micro [B, T, micro_embed_dim] (frame 0's row zero in clip mode)
        and emb [B, T, 2048] -> [B, T, num_outputs]."""
        p = self.p if params is None else params
        ym = self.gru(micro, p, "temporal.gru_micro")
        macro = F.relu(F.linear(emb, p["temporal.macro_proj.weight"],
                                p["temporal.macro_proj.bias"]))
        ya = self.gru(macro, p, "temporal.gru_macro")
        fused = F.relu(F.linear(torch.cat([ym, ya], dim=-1),
                                p["temporal.fusion.weight"],
                                p["temporal.fusion.bias"]))
        out = F.linear(fused, p["temporal.head.weight"], p["temporal.head.bias"])
        if self.cfg["temporal"]["output_activation"] == "tanh":
            out = torch.tanh(out)
        return out

    def micro_sequence(self, stacks: torch.Tensor, params=None,
                       train: bool = False, block: int = 512) -> torch.Tensor:
        """[B, T-1, C, P, P] stacks -> [B, T, micro_embed_dim], frame 0's
        row zero (clip mode: frame 0 has no predecessor)."""
        p = self.p if params is None else params
        b, tm1 = stacks.shape[:2]
        flat = stacks.reshape((b * tm1,) + tuple(stacks.shape[2:]))
        if train:
            m = self.micro_embed(flat, p, train=True)
        else:
            m = torch.cat([self.micro_embed(flat[i:i + block], p)
                           for i in range(0, flat.shape[0], block)])
        return F.pad(m.reshape(b, tm1, -1), (0, 0, 1, 0))

    def clips(self, crops: torch.Tensor) -> torch.Tensor:
        """[B, T, S, S, 3] clips (0..255) -> [B, T, 2], clip mode."""
        b, t = crops.shape[:2]
        with torch.no_grad(), self.precision():
            stacks = torch.stack([self.phase(c) for c in crops])
            emb = self.embed(crops.reshape((b * t,) + tuple(crops.shape[2:])))
            return self.temporal(self.micro_sequence(stacks),
                                 emb.reshape(b, t, -1))


# -- training --------------------------------------------------------------------

def ccc(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
        eps: float = 1e-8) -> torch.Tensor:
    """Concordance correlation of [T, D] sequences over the frames that
    ``mask`` [T] marks, with population moments: [D]."""
    m = mask[:, None]
    n = m.sum(dim=0) + eps
    mu_p, mu_t = (pred * m).sum(0) / n, (target * m).sum(0) / n
    dp, dt = (pred - mu_p) * m, (target - mu_t) * m
    var_p, var_t = (dp * dp).sum(0) / n, (dt * dt).sum(0) / n
    cov = (dp * dt).sum(0) / n
    return 2.0 * cov / (var_p + var_t + (mu_p - mu_t) ** 2 + eps)


def clip_loss(out: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """1 - CCC per clip (mean over valence and arousal), averaged over the
    clips that have a valid frame."""
    per = torch.stack([(1.0 - ccc(out[i], labels[i], mask[i])).mean()
                       for i in range(out.shape[0])])
    w = (mask.sum(dim=1) > 0).to(torch.float32)
    return (per * w).sum() / (w.sum() + 1e-8)


FAULTS = ("half_batch", "altered")


def train_steps(ref: Reference, batches: Sequence[dict], lr: float,
                betas=(0.9, 0.999), eps: float = 1e-8,
                fault: Optional[str] = None,
                resume: Optional[dict] = None) -> dict:
    """Adam on the temporal model's parameters with the backbone frozen,
    one step per batch (``clips`` [B, T, S, S, 3], ``labels`` [B, T, 2],
    ``mask`` [B, T]). Returns the loss of each step, each parameter's
    first gradient, and each parameter before the first step and after
    the last.

    The steps start from ``ref``'s weights and fresh moments, or, with
    ``resume``, from a training state part way through: ``params``,
    ``exp_avg`` and ``exp_avg_sq`` (name -> tensor) and ``count``, the
    updates already made.

    ``fault`` plants a fault a step could have, to read what the check
    makes of it: ``"half_batch"`` leaves out the second half of the clips
    and takes the loss over the rest; ``"altered"`` adds 1 to the first
    clip's first predicted valence."""
    if fault not in (None,) + FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    spec = ref.cfg["train"]
    if (spec["lr_schedule"] != "constant" or spec["warmup_steps"]
            or spec["weight_decay"] or spec["loss"] != "ccc"
            or spec["loss_axis"] != "time" or spec["augment"]
            or spec["brightness_jitter"] or not spec["freeze_backbone"]):
        raise ValueError("the reference trains the frozen-backbone step "
                         "with Adam at a constant rate on the per-clip CCC")
    names = [k for k in ref.p if k.startswith("temporal.")
             and "running_" not in k]
    def own(tensors):
        return {k: tensors[k].detach().to(ref.device, torch.float32).clone()
                for k in names}

    if resume is None:
        params = own(ref.p)
        m = {k: torch.zeros_like(v) for k, v in params.items()}
        v2 = {k: torch.zeros_like(v) for k, v in params.items()}
        done = 0
    else:
        params, m, v2 = (own(resume["params"]), own(resume["exp_avg"]),
                         own(resume["exp_avg_sq"]))
        done = int(resume["count"])
    start = {k: v.clone() for k, v in params.items()}
    losses, first_grad = [], None
    for step, batch in enumerate(batches, done + 1):
        batch = dict(batch)
        if fault == "half_batch":
            half = batch["clips"].shape[0] // 2
            batch = {k: v[:half] for k, v in batch.items()}
        crops = batch["clips"].to(ref.device)
        b, t = crops.shape[:2]
        with torch.no_grad(), ref.precision():
            stacks = torch.stack([ref.phase(c) for c in crops])
            emb = ref.embed(crops.reshape((b * t,) + tuple(crops.shape[2:])))
        leaves = {k: p.requires_grad_(True) for k, p in params.items()}
        with ref.precision():
            out = ref.temporal(ref.micro_sequence(stacks, leaves, train=True),
                               emb.reshape(b, t, -1), leaves)
            if fault == "altered":
                out = out.clone()
                out[0, 0, 0] = out[0, 0, 0] + 1.0
            loss = clip_loss(out, batch["labels"].to(ref.device, torch.float32),
                             batch["mask"].to(ref.device, torch.float32))
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        losses.append(float(loss.detach()))
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in zip(names, grads)}
        with torch.no_grad():
            for k, g in zip(names, grads):
                m[k] = betas[0] * m[k] + (1 - betas[0]) * g
                v2[k] = betas[1] * v2[k] + (1 - betas[1]) * g * g
                m_hat = m[k] / (1 - betas[0] ** step)
                v_hat = v2[k] / (1 - betas[1] ** step)
                params[k] = (params[k] - lr * m_hat / (v_hat.sqrt() + eps)
                             ).detach()
    return {"losses": losses, "first_grad": first_grad, "start": start,
            "end": params}
