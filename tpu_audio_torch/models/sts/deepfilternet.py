"""DeepFilterNet (v2/v3) speech enhancement on the PyTorch port.

Port of tpu_audio.models.sts.deepfilternet: a vorbis-window STFT with
libDF's ``wnorm = 2 hop / fft^2`` scaling, ERB energies in dB and the
complex low bins, each normalised by an exponential moving average over
frames; a UNet-like conv encoder and decoder with causal time padding,
grouped linears and squeezed GRUs; an ERB mask decoder (sigmoid gains
lifted to every bin through ``mask.erb_inv_fb``) and a deep-filter decoder
whose complex FIR taps filter the lowest ``nb_df`` bins; then the
overlap-add ISTFT.

Activations are ``[B, C, T, F]`` (cuDNN's layout), where the JAX package's
are channels-last ``[B, T, F, C]``: each flatten into a grouped linear and
the unflatten of the ERB decoder's GRU output permute to ``[B, T, F, C]``
first, so that every weight reads the features it reads there. Everything
after the waveform's upload runs on the params' device in plain PyTorch ops
(no kernel of the port: the JAX package reaches no Pallas kernel here
either; its ERB features are ``10 log10(P @ fb + 1e-10)`` over a
mean-pooling band matrix, not kernel 1's clamped log-mel), with the
convolutions in full f32 (``nn.f32_convolutions``).

``DeepFilterNet.enhance`` runs at the input's exact length (the JAX
package's 16-hop buckets only bound its jit cache and give the same
samples). :class:`DeepFilterNetStreamer` steps hop by hop with carried
state; each ``process_chunk`` enqueues its hops on the device with no host
read between them and reads the chunk back once.
"""

from __future__ import annotations

import functools
import math
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tpu_audio_torch.core import dsp, hub, loading, nn

__all__ = ["DeepFilterNet", "DeepFilterNetConfig", "DeepFilterNetStreamer",
           "vorbis_window", "erb_band_widths", "compute_norm_alpha", "init_random_params"]


@dataclass
class DeepFilterNetConfig:
    sample_rate: int = 48000
    fft_size: int = 960
    hop_size: int = 480
    min_nb_erb_freqs: int = 2
    nb_erb: int = 32
    nb_df: int = 96
    df_order: int = 5
    df_lookahead: int = 2
    conv_lookahead: int = 2
    conv_ch: int = 64
    emb_hidden_dim: int = 256
    emb_num_layers: int = 3
    df_hidden_dim: int = 256
    df_num_layers: int = 2
    enc_concat: bool = False
    lsnr_max: int = 35
    lsnr_min: int = -15
    model_version: str = "DeepFilterNet3"

    @property
    def freq_bins(self) -> int:
        return self.fft_size // 2 + 1

    @classmethod
    def from_dict(cls, d: dict) -> "DeepFilterNetConfig":
        alias = {
            "sampleRate": "sample_rate", "fftSize": "fft_size",
            "hopSize": "hop_size", "minNbErbFreqs": "min_nb_erb_freqs",
            "nbErb": "nb_erb", "nbDf": "nb_df", "dfOrder": "df_order",
            "dfLookahead": "df_lookahead", "convLookahead": "conv_lookahead",
            "convCh": "conv_ch", "embHiddenDim": "emb_hidden_dim",
            "embNumLayers": "emb_num_layers", "dfHiddenDim": "df_hidden_dim",
            "dfNumLayers": "df_num_layers", "encConcat": "enc_concat",
            "lsnrMax": "lsnr_max", "lsnrMin": "lsnr_min",
            "modelVersion": "model_version",
        }
        keys = set(cls.__dataclass_fields__)
        kw = {}
        for k, v in d.items():
            k = alias.get(k, k)
            if k in keys:
                kw[k] = v
        return cls(**kw)


# ---------------------------------------------------------------------------
# DSP (host-side NumPy, as in the JAX package)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def vorbis_window(size: int) -> np.ndarray:
    half = max(1, size // 2)
    i = np.arange(size)
    inner = np.sin(0.5 * np.pi * (i + 0.5) / half)
    return np.sin(0.5 * np.pi * inner * inner).astype(np.float32)


def _freq_to_erb(f):
    return 9.265 * np.log1p(f / (24.7 * 9.265))


def _erb_to_freq(e):
    return 24.7 * 9.265 * (np.exp(e / 9.265) - 1.0)


def erb_band_widths(sample_rate: int, fft_size: int, nb_bands: int,
                    min_nb_freqs: int) -> list[int]:
    """libDF's ERB band widths in bins, summing to ``fft_size // 2 + 1``."""
    nyq = sample_rate / 2
    freq_width = sample_rate / fft_size
    erb_low, erb_high = _freq_to_erb(0.0), _freq_to_erb(nyq)
    step = (erb_high - erb_low) / nb_bands
    widths = []
    prev = over = 0
    for i in range(1, nb_bands + 1):
        fb = int(round(_erb_to_freq(erb_low + i * step) / freq_width))
        nb = fb - prev - over
        if nb < min_nb_freqs:
            over = min_nb_freqs - nb
            nb = min_nb_freqs
        else:
            over = 0
        widths.append(max(1, nb))
        prev = fb
    widths[-1] += 1
    target = fft_size // 2 + 1
    widths[-1] += target - sum(widths)
    return widths


def compute_norm_alpha(hop_size: int, sample_rate: int) -> float:
    """The feature EMA's decay, ``exp(-hop / sr)`` rounded to the fewest
    decimals (from 3) that leave it below 1."""
    a_raw = math.exp(-hop_size / sample_rate)
    precision = 3
    a = 1.0
    while a >= 1.0:
        scale = 10.0**precision
        a = round(a_raw * scale) / scale
        precision += 1
    return a


def _stft(audio: torch.Tensor, window: np.ndarray, n_fft: int, hop: int) -> torch.Tensor:
    """Non-centred STFT ``[T, F]`` of a 1D signal whose tail is first
    zero-padded to whole frames (``torch.stft(center=False)`` alone would
    drop the partial last frame)."""
    n = audio.shape[0]
    n_frames = 1 + (n - n_fft + hop - 1) // hop
    need = n_fft + (n_frames - 1) * hop
    if need > n:
        audio = F.pad(audio, (0, need - n))
    return dsp.stft(audio, window, n_fft, hop, center=False)


def _norm_init(start: float, stop: float, n: int, device) -> torch.Tensor:
    """The EMA's initial state, a linear ramp over the bands (f32)."""
    return torch.linspace(start, stop, n, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Network pieces over [B, C, T, F] (weights keep the checkpoint's layout)
# ---------------------------------------------------------------------------


def _groups(w: torch.Tensor, x: torch.Tensor) -> int:
    """A conv's groups, from its input channels and weight ``[O, I/g, kT, kF]``."""
    return max(1, x.shape[1] // w.shape[1])


def _conv2d(w: torch.Tensor, x: torch.Tensor, fstride: int, lookahead: int = 0) -> torch.Tensor:
    """Conv over ``[B, C, T, F]``, causal in time (``k_t - 1 - lookahead``
    zero frames before, ``lookahead`` after), ``k_f // 2`` zero bins each
    side, stride ``fstride`` over frequency; torch weight ``[O, I/g, kT,
    kF]``."""
    k_t, k_f = w.shape[2], w.shape[3]
    g = _groups(w, x)
    left = k_t - 1 - lookahead
    crop = max(0, -left)
    if crop and x.shape[2] > crop:
        x = x[:, :, crop:]
    if left > 0 or lookahead > 0:
        x = F.pad(x, (0, 0, max(0, left), max(0, lookahead)))
    return F.conv2d(x, w.to(x.dtype), stride=(1, fstride), padding=(0, k_f // 2), groups=g)


def _convt2d(w: torch.Tensor, x: torch.Tensor, fstride: int, groups: int) -> torch.Tensor:
    """Grouped transposed conv over ``[B, C, T, F]``; torch weight ``[I,
    O/g, kT, kF]``, padding ``(kT - 1, kF // 2)`` and output padding ``(0,
    kF // 2)``, as the reference's."""
    k_t, k_f = w.shape[2], w.shape[3]
    return F.conv_transpose2d(x, w.to(x.dtype), stride=(1, fstride),
                              padding=(k_t - 1, k_f // 2), output_padding=(0, k_f // 2),
                              groups=groups)


def _bn_consts(p: dict, prefix: str) -> tuple:
    """An inference BatchNorm's ``(mean, scale, bias)`` over channel dim 1
    of ``[B, C, T, F]``, ``scale = weight / sqrt(var + 1e-5)``, computed
    once a model."""
    scale = p[f"{prefix}.weight"] / torch.sqrt(p[f"{prefix}.running_var"] + 1e-5)
    return tuple(v.reshape(-1, 1, 1) for v in (p[f"{prefix}.running_mean"], scale,
                                                p[f"{prefix}.bias"]))


def _batch_norm(consts: tuple, x: torch.Tensor) -> torch.Tensor:
    """``(x - mean) * scale + bias`` over channel dim 1."""
    mean, scale, bias = consts
    return torch.addcmul(bias, x - mean, scale)


def _grouped_linear(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``w [groups, in/groups, out/groups]``; ``x [B, T, in]`` -> ``[B, T,
    out]``."""
    g, ws, hs = w.shape
    b, t, _ = x.shape
    return torch.einsum("btgi,gih->btgh", x.reshape(b, t, g, ws),
                        w.to(x.dtype)).reshape(b, t, g * hs)


def _flat(x: torch.Tensor) -> torch.Tensor:
    """``[B, C, T, F]`` -> ``[B, T, F * C]``, the JAX package's flatten of
    channels-last ``(F, C)``."""
    b, _, t, _ = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, t, -1)


def _gru_layers(p: dict, prefix: str) -> int:
    n = 0
    while f"{prefix}.gru.weight_ih_l{n}" in p:
        n += 1
    return n


def _squeezed_gru_stream(p: dict, prefix: str, x: torch.Tensor, hs, linear_out: bool):
    """Grouped linear in (ReLU), every GRU layer the keys hold (``h0`` from
    ``hs``; offline, and at a stream's start, None: zeros), grouped linear
    out (ReLU) where asked and present -> ``(y, [h of each layer])``."""
    y = torch.relu(_grouped_linear(p[f"{prefix}.linear_in.0.weight"], x))
    new_hs = []
    for layer in range(_gru_layers(p, prefix)):
        gp = {k: p[f"{prefix}.gru.{k}_l{layer}"] for k in
              ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
              if f"{prefix}.gru.{k}_l{layer}" in p}
        y, h = nn.gru(gp, y, h0=hs[layer] if hs is not None else None)
        new_hs.append(h)
    if linear_out and f"{prefix}.linear_out.0.weight" in p:
        y = torch.relu(_grouped_linear(p[f"{prefix}.linear_out.0.weight"], y))
    return y, new_hs


# -- streaming variants: a carried time tail instead of left padding --------


def _conv2d_stream(w: torch.Tensor, x: torch.Tensor, tail, fstride: int):
    """Time-valid conv over new frames ``x [B, C, n, F]`` after the carried
    tail ``[B, C, k_t - 1, F]`` (zeros at the stream's start, which is the
    offline left padding) -> ``(y [B, O, n, F'], new tail)``."""
    k_t, k_f = w.shape[2], w.shape[3]
    g = _groups(w, x)
    if k_t > 1:
        x = torch.cat([tail, x], dim=2)
        tail = x[:, :, -(k_t - 1):]
    y = F.conv2d(x, w.to(x.dtype), stride=(1, fstride), padding=(0, k_f // 2), groups=g)
    return y, tail


class _TailStore:
    """Per-conv time tails by conv name; a conv with ``k_t > 1`` starts
    from a zero tail, made at its first frame."""

    def __init__(self, tails: dict):
        self.tails = dict(tails)

    def conv(self, p: dict, name: str, x: torch.Tensor, fstride: int) -> torch.Tensor:
        w = p[f"{name}.weight"]
        k_t = w.shape[2]
        if k_t > 1:
            tail = self.tails.get(name)
            if tail is None:
                tail = x.new_zeros((x.shape[0], x.shape[1], k_t - 1, x.shape[3]))
            y, self.tails[name] = _conv2d_stream(w, x, tail, fstride)
            return y
        return _conv2d_stream(w, x, None, fstride)[0]


# ---------------------------------------------------------------------------
# Random weights
# ---------------------------------------------------------------------------


# init_random_params' grouped linears: the fixture writer's groups (no published
# DeepFilterNet3 config is in the repository)
LINEAR_GROUPS = 4


def init_random_params(cfg: DeepFilterNetConfig, seed: int = 0, device=None) -> dict:
    """Random f32 params in the checkpoint's flat layout at ``cfg``'s widths,
    drawn on ``device`` from a ``torch.Generator``, with DeepFilterNet3's
    GRU layer counts: ``enc.emb_gru`` 1, ``erb_dec.emb_gru``
    ``emb_num_layers - 1``, ``df_dec.df_gru`` ``df_num_layers``; the grouped
    linears in LINEAR_GROUPS groups, the embedding ``conv_ch * nb_erb // 4``
    wide. Scales: conv and grouped-linear weights N(0, 2 / fan_in) (ReLU
    gain), ``df_dec.df_out`` and ``df_dec.df_convp.2`` N(0, 1 / fan_in) and
    ``df_dec.df_skip`` N(0, 0.25 / fan_in), so that tanh and the deep
    filter's taps stay off saturation; GRU weights and biases N(0, 1 / H);
    BatchNorm weights 1 + N(0, 0.1), biases and running means N(0, 0.1),
    running variances in [0.5, 1.5), those of the ERB encoder's first
    block 0.01x (its input, dB deviations over 40, sits near 0.1) and of
    the mask's 16x (so that the sigmoid gains spread over (0, 1) without
    saturating). ``mask.erb_inv_fb`` is the band-to-bin assignment of
    ``erb_band_widths`` (each bin takes its band's gain), as the
    reference's fixed buffer."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    gen = torch.Generator(device=device).manual_seed(seed)
    c, e, ndf, do = cfg.conv_ch, cfg.nb_erb, cfg.nb_df, cfg.df_order
    h, hd, g = cfg.emb_hidden_dim, cfg.df_hidden_dim, LINEAR_GROUPS
    emb = c * (e // 4)
    p: dict[str, torch.Tensor] = {}

    def randn(*shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    def conv(name, *shape, gain=2.0):
        fan_in = shape[1] * shape[2] * shape[3]
        p[name] = randn(*shape, std=(gain / fan_in) ** 0.5)

    def bn(prefix, ch, var_scale=1.0):
        p[f"{prefix}.weight"] = 1.0 + randn(ch, std=0.1)
        p[f"{prefix}.bias"] = randn(ch, std=0.1)
        p[f"{prefix}.running_mean"] = randn(ch, std=0.1)
        p[f"{prefix}.running_var"] = (0.5 + torch.rand((ch,), generator=gen, device=device)
                                      ) * var_scale

    def lin(name, n_in, n_out, gain=2.0):
        p[name] = randn(g, n_in // g, n_out // g, std=(gain / (n_in // g)) ** 0.5)

    def gru(prefix, n_in, hid, layers):
        for i in range(layers):
            std = (1.0 / hid) ** 0.5
            p[f"{prefix}.weight_ih_l{i}"] = randn(3 * hid, n_in if i == 0 else hid, std=std)
            p[f"{prefix}.weight_hh_l{i}"] = randn(3 * hid, hid, std=std)
            p[f"{prefix}.bias_ih_l{i}"] = randn(3 * hid, std=std)
            p[f"{prefix}.bias_hh_l{i}"] = randn(3 * hid, std=std)

    conv("enc.erb_conv0.1.weight", c, 1, 3, 3)
    bn("enc.erb_conv0.2", c, var_scale=0.01)
    for i in (1, 2, 3):
        conv(f"enc.erb_conv{i}.0.weight", c, 1, 1, 3)
        conv(f"enc.erb_conv{i}.1.weight", c, c, 1, 1)
        bn(f"enc.erb_conv{i}.2", c)
    conv("enc.df_conv0.1.weight", c, 2, 3, 3)
    conv("enc.df_conv0.2.weight", c, c, 1, 1)
    bn("enc.df_conv0.3", c)
    conv("enc.df_conv1.0.weight", c, 1, 1, 3)
    conv("enc.df_conv1.1.weight", c, c, 1, 1)
    bn("enc.df_conv1.2", c)
    lin("enc.df_fc_emb.0.weight", c * (ndf // 2), emb)
    lin("enc.emb_gru.linear_in.0.weight", emb, h)
    gru("enc.emb_gru.gru", h, h, 1)
    lin("enc.emb_gru.linear_out.0.weight", h, emb)
    lin("erb_dec.emb_gru.linear_in.0.weight", emb, h)
    gru("erb_dec.emb_gru.gru", h, h, cfg.emb_num_layers - 1)
    lin("erb_dec.emb_gru.linear_out.0.weight", h, emb)
    for pfx in ("conv3p", "conv2p", "conv1p", "conv0p"):
        conv(f"erb_dec.{pfx}.0.weight", c, c, 1, 1)
        bn(f"erb_dec.{pfx}.1", c)
    conv("erb_dec.convt3.0.weight", c, c, 1, 3)
    conv("erb_dec.convt3.1.weight", c, c, 1, 1)
    bn("erb_dec.convt3.2", c)
    for pfx in ("convt2", "convt1"):
        conv(f"erb_dec.{pfx}.0.weight", c, 1, 1, 3)  # grouped transpose [I, O/g, kT, kF]
        conv(f"erb_dec.{pfx}.1.weight", c, c, 1, 1)
        bn(f"erb_dec.{pfx}.2", c)
    conv("erb_dec.conv0_out.0.weight", 1, c, 1, 3)
    bn("erb_dec.conv0_out.1", 1, var_scale=16.0)
    lin("df_dec.df_gru.linear_in.0.weight", emb, hd)
    gru("df_dec.df_gru.gru", hd, hd, cfg.df_num_layers)
    lin("df_dec.df_skip.weight", emb, hd, gain=0.25)
    conv("df_dec.df_convp.1.weight", c, 1, 1, 3)
    conv("df_dec.df_convp.2.weight", 2 * do, c, 1, 1, gain=1.0)
    bn("df_dec.df_convp.3", 2 * do)
    lin("df_dec.df_out.0.weight", hd, ndf * do * 2, gain=1.0)
    inv = np.zeros((e, cfg.freq_bins), np.float32)
    start = 0
    for j, wdt in enumerate(erb_band_widths(cfg.sample_rate, cfg.fft_size, e,
                                            cfg.min_nb_erb_freqs)):
        inv[j, start: start + wdt] = 1.0
        start += wdt
    p["mask.erb_inv_fb"] = torch.from_numpy(inv).to(device)
    return p


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class DeepFilterNet:
    """DeepFilterNet on its params' device: ``enhance`` (offline, numpy in
    and out), ``enhance_streaming`` (a generator of chunks over
    :class:`DeepFilterNetStreamer`). ``params`` is the checkpoint's flat
    dict (keys as in the safetensors file). ``dtype`` is the network's
    input dtype, as in the JAX package: the weights stay as loaded, each
    conv and linear runs in its input's dtype, and the f32 BatchNorm
    promotes what follows it to f32."""

    def __init__(self, config: DeepFilterNetConfig, params: dict, dtype=torch.float32):
        self.config = config
        self.dtype = dtype
        self.params = params
        self.device = params["mask.erb_inv_fb"].device
        self.sample_rate = config.sample_rate
        self.widths = erb_band_widths(config.sample_rate, config.fft_size, config.nb_erb,
                                      config.min_nb_erb_freqs)
        self.norm_alpha = compute_norm_alpha(config.hop_size, config.sample_rate)
        self.wnorm = 2.0 * config.hop_size / (config.fft_size**2)
        # dense ERB filterbank from the widths (mean pooling a band); a
        # checkpoint's own erb_fb takes precedence
        fb = np.zeros((config.freq_bins, config.nb_erb), np.float32)
        start = 0
        for j, wdt in enumerate(self.widths):
            stop = min(start + wdt, config.freq_bins)
            if stop > start:
                fb[start:stop, j] = 1.0 / (stop - start)
            start = stop
        self.erb_fb = (params["erb_fb"].to(device=self.device, dtype=torch.float32)
                       if "erb_fb" in params else torch.from_numpy(fb).to(self.device))
        self.window = torch.from_numpy(vorbis_window(config.fft_size)).to(self.device)
        self._bn = {k[: -len(".running_mean")]: _bn_consts(self.params, k[: -len(".running_mean")])
                    for k in self.params if k.endswith(".running_mean")}

    @classmethod
    def from_pretrained(cls, repo_or_path: str, dtype=torch.float32,
                        device="cuda") -> "DeepFilterNet":
        """Load a local checkpoint directory (``config.json`` and the flat
        safetensors) onto ``device``."""
        model_dir = hub.resolve_model_dir(repo_or_path)
        config = DeepFilterNetConfig.from_dict(hub.load_config(model_dir))
        params = loading.to_device(loading.load_safetensors(model_dir), device)
        return cls(config, params, dtype)

    # -- feature normalisation (an EMA over frames) ----------------------------

    def _ema(self, x: torch.Tensor, init_row: torch.Tensor) -> torch.Tensor:
        """``s_t = a s_{t-1} + (1 - a) x_t`` with ``s_{-1} = init / a``, over
        the frames of ``x [T, n]``, as a log-depth (Hillis-Steele) scan of the
        linear recurrence: step ``k`` adds ``a^k`` times the partial sum ``k``
        frames back. Nothing divides by a decayed power, so no length
        overflows (a closed form through ``a^t`` turns to NaN past ~88 s)."""
        a = self.norm_alpha
        b = (1 - a) * x
        b = torch.cat([b[:1] + init_row, b[1:]])  # a * (init / a) folded into frame 0
        k = 1
        while k < b.shape[0]:
            b = torch.cat([b[:k], b[k:] + (a**k) * b[:-k]])
            k *= 2
        return b

    def _band_mean_norm(self, x: torch.Tensor) -> torch.Tensor:
        state = self._ema(x, _norm_init(-60.0, -90.0, x.shape[1], x.device))
        return (x - state) / 40.0

    def _band_unit_norm(self, real: torch.Tensor, imag: torch.Tensor):
        mag = torch.sqrt(real**2 + imag**2)
        state = self._ema(mag, _norm_init(0.001, 0.0001, real.shape[1], real.device))
        denom = torch.sqrt(torch.clamp(state, min=1e-12))
        return real / denom, imag / denom

    @staticmethod
    def _lookahead(x: torch.Tensor, n: int) -> torch.Tensor:
        """Shift ``[B, C, T, F]`` ``n`` frames earlier, zeros after."""
        if n <= 0 or x.shape[2] <= n:
            return x
        return F.pad(x[:, :, n:], (0, 0, 0, n))

    def features(self, padded: torch.Tensor):
        """The signal (already padded as ``enhance`` pads it) -> ``(spec_ri
        [T, F, 2], feat_erb [T, nb_erb], feat_df [T, nb_df, 2])``: the
        scaled spectrum, the normalised ERB dB and the unit-normalised low
        bins."""
        cfg = self.config
        spec = _stft(padded, vorbis_window(cfg.fft_size), cfg.fft_size, cfg.hop_size)
        spec_ri = torch.view_as_real(spec * self.wnorm)
        re, im = spec_ri[..., 0], spec_ri[..., 1]
        erb = (re**2 + im**2) @ self.erb_fb
        feat_erb = self._band_mean_norm(10.0 * torch.log10(erb + 1e-10))
        dfr, dfi = self._band_unit_norm(re[:, : cfg.nb_df], im[:, : cfg.nb_df])
        return spec_ri, feat_erb, torch.stack([dfr, dfi], dim=-1)

    # -- network ------------------------------------------------------------------

    def _net(self, x_erb: torch.Tensor, x_df: torch.Tensor, conv, grus: dict):
        """``x_erb [B, 1, T, nb_erb]``, ``x_df [B, 2, T, nb_df]`` (already
        shifted by the lookahead) -> ``(gains [B, T, F], coefs [B, T, nb_df,
        df_order, 2], GRU hiddens by prefix)``. ``conv(name, x, fstride)`` is
        the offline causal conv or the streamer's tail store; ``grus`` the
        GRU hiddens to start from (none: zeros)."""
        cfg, p = self.config, self.params
        new_grus = {}

        def bn(prefix, x):
            return _batch_norm(self._bn[prefix], x)

        def enc(prefix, x, main, pointwise, norm, fstride):
            y = conv(f"{prefix}.{main}", x, fstride)
            if pointwise is not None:
                y = conv(f"{prefix}.{pointwise}", y, 1)
            return torch.relu(bn(f"{prefix}.{norm}", y))

        e0 = enc("enc.erb_conv0", x_erb, 1, None, 2, 1)
        e1 = enc("enc.erb_conv1", e0, 0, 1, 2, 2)
        e2 = enc("enc.erb_conv2", e1, 0, 1, 2, 2)
        e3 = enc("enc.erb_conv3", e2, 0, 1, 2, 1)
        c0 = enc("enc.df_conv0", x_df, 1, 2, 3, 1)
        c1 = enc("enc.df_conv1", c0, 0, 1, 2, 2)

        b, t = c1.shape[0], c1.shape[2]
        cemb = torch.relu(_grouped_linear(p["enc.df_fc_emb.0.weight"], _flat(c1)))
        emb = _flat(e3)
        emb = torch.cat([emb, cemb], -1) if cfg.enc_concat else emb + cemb
        emb, new_grus["enc.emb_gru"] = _squeezed_gru_stream(
            p, "enc.emb_gru", emb, grus.get("enc.emb_gru"), True)

        # ERB mask decoder; the GRU's output unflattens as channels-last (F, C)
        d, new_grus["erb_dec.emb_gru"] = _squeezed_gru_stream(
            p, "erb_dec.emb_gru", emb, grus.get("erb_dec.emb_gru"), True)
        d = d.reshape(b, t, e3.shape[3], -1).permute(0, 3, 1, 2)

        def pathway(prefix, x):
            return torch.relu(bn(f"{prefix}.1", conv(f"{prefix}.0", x, 1)))

        def transpose_block(prefix, x, fstride):
            y = _convt2d(p[f"{prefix}.0.weight"], x, fstride, groups=cfg.conv_ch)
            return bn(f"{prefix}.2", conv(f"{prefix}.1", y, 1))

        def regular_block(prefix, x):
            y = conv(f"{prefix}.1", conv(f"{prefix}.0", x, 1), 1)
            return bn(f"{prefix}.2", y)

        d3 = torch.relu(pathway("erb_dec.conv3p", e3)) + d
        d3 = torch.relu(regular_block("erb_dec.convt3", d3))
        d2 = torch.relu(pathway("erb_dec.conv2p", e2)) + d3
        d2 = torch.relu(transpose_block("erb_dec.convt2", d2, 2))
        d1 = torch.relu(pathway("erb_dec.conv1p", e1)) + d2
        d1 = torch.relu(transpose_block("erb_dec.convt1", d1, 2))
        d0 = torch.relu(pathway("erb_dec.conv0p", e0)) + d1
        out = conv("erb_dec.conv0_out.0", d0, 1)
        mask = torch.sigmoid(bn("erb_dec.conv0_out.1", out))  # [B, 1, T, E]
        gains = mask[:, 0] @ p["mask.erb_inv_fb"].to(mask.dtype)

        # deep-filter coefficient decoder
        c, new_grus["df_dec.df_gru"] = _squeezed_gru_stream(
            p, "df_dec.df_gru", emb, grus.get("df_dec.df_gru"), False)
        if "df_dec.df_skip.weight" in p:
            c = c + _grouped_linear(p["df_dec.df_skip.weight"], emb)
        c0p = conv("df_dec.df_convp.2", conv("df_dec.df_convp.1", c0, 1), 1)
        c0p = torch.relu(bn("df_dec.df_convp.3", c0p))
        df_out = torch.tanh(_grouped_linear(p["df_dec.df_out.0.weight"], c)
                            ).reshape(b, t, cfg.nb_df, cfg.df_order * 2)
        coefs = (df_out + c0p.permute(0, 2, 3, 1)).reshape(b, t, cfg.nb_df, cfg.df_order, 2)
        return gains, coefs, new_grus

    def _forward_impl(self, spec_ri: torch.Tensor, feat_erb: torch.Tensor,
                      feat_df: torch.Tensor) -> torch.Tensor:
        """``spec_ri [T, F, 2]``, ``feat_erb [T, nb_erb]``, ``feat_df [T,
        nb_df, 2]`` -> the enhanced spectrum ``[T, F, 2]``."""
        cfg, p = self.config, self.params
        x_erb = self._lookahead(feat_erb[None, None], cfg.conv_lookahead)
        x_df = self._lookahead(feat_df.permute(2, 0, 1)[None], cfg.conv_lookahead)
        with nn.f32_convolutions():
            gains, coefs, _ = self._net(
                x_erb, x_df, lambda name, x, fs: _conv2d(p[f"{name}.weight"], x, fs), {})
        t = spec_ri.shape[0]
        spec_masked = spec_ri * gains[0][..., None]
        # deep filtering over the low bins: output frame t takes the taps
        # over frames t - (order - 1 - lookahead) .. t + lookahead
        pad_left = cfg.df_order - 1 - cfg.df_lookahead
        padded = F.pad(spec_ri[:, : cfg.nb_df], (0, 0, 0, 0, pad_left, cfg.df_lookahead))
        out_r = out_i = 0.0
        for k in range(cfg.df_order):
            win = padded[k: k + t]
            sr, si = win[..., 0], win[..., 1]
            cr, ci = coefs[0, :, :, k, 0], coefs[0, :, :, k, 1]
            out_r = out_r + sr * cr - si * ci
            out_i = out_i + sr * ci + si * cr
        low = torch.stack([out_r, out_i], dim=-1)
        return torch.cat([low, spec_masked[:, cfg.nb_df:]], dim=1)

    # -- public API ---------------------------------------------------------------

    @torch.inference_mode()
    def _enhance_impl(self, audio: torch.Tensor) -> torch.Tensor:
        """The whole pipeline on the device: ``hop`` zeros before the audio
        and ``fft`` after, STFT, features, network, ISTFT, the ``fft - hop``
        delay cut off, clipped to [-1, 1]."""
        cfg = self.config
        n = audio.shape[0]
        padded = F.pad(audio, (cfg.hop_size, cfg.fft_size))
        spec_ri, feat_erb, feat_df = self.features(padded)
        enhanced = self._forward_impl(spec_ri.to(self.dtype), feat_erb.to(self.dtype),
                                      feat_df.to(self.dtype)).to(torch.float32)
        enh = torch.complex(enhanced[..., 0], enhanced[..., 1]) / self.wnorm
        out = dsp.istft(enh, vorbis_window(cfg.fft_size), cfg.fft_size, cfg.hop_size,
                        length=n + cfg.hop_size + cfg.fft_size, center=False)
        delay = cfg.fft_size - cfg.hop_size
        return torch.clamp(out[delay: delay + n], -1.0, 1.0)

    def enhance(self, audio) -> np.ndarray:
        """Enhance a mono float32 waveform at ``sample_rate``; same length."""
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(audio, np.float32).reshape(-1)))
        return self._enhance_impl(x.to(self.device)).cpu().numpy()

    def enhance_streaming(self, audio, chunk_samples: int | None = None):
        """Chunked enhancement generator over the hop-by-hop streamer: the
        chunks join to ``enhance``'s output (within the streamed EMA's
        rounding), and to the input's length."""
        cfg = self.config
        chunk = chunk_samples or cfg.hop_size * 25
        audio = np.asarray(audio, np.float32).reshape(-1)
        streamer = DeepFilterNetStreamer(self)
        for start in range(0, len(audio), chunk):
            out = streamer.process_chunk(audio[start: start + chunk])
            if len(out):
                yield out
        tail = streamer.flush()
        if len(tail):
            yield tail


class DeepFilterNetStreamer:
    """Stateful hop-by-hop enhancement, equal to offline
    :meth:`DeepFilterNet.enhance` on the same total input (within the
    recurrent EMA's rounding against the offline scan). Where the JAX
    package's streamer departs from its own offline path (with a conv
    lookahead ``cl > 0``: it runs the network on the first ``cl`` frames,
    which offline's lookahead shift drops, and flushes zero features where
    offline's tail padding gives one more frame of silence), this one
    follows the offline path.

    Carried state on the model's device: the EMA feature-norm states, a
    time tail a conv with ``k_t > 1`` (offline's causal left padding), each
    GRU layer's hidden, a ring of the last ``S`` spectra (written twice, at
    ``s % S`` and ``s % S + S``, so that the deep filter's window of
    consecutive frames is one slice), rings of the last ``Dc`` gains and
    coefficients, and the overlap-add tails. The output lags the input by
    ``D = max(conv_lookahead, df_lookahead)`` hops, offline's lookahead
    shifts. Every index is the host's hop count, so a chunk's hops run with
    no host read; ``process_chunk`` uploads the chunk's frames once and
    reads its output back once."""

    def __init__(self, model: DeepFilterNet):
        self.model = model
        cfg = model.config
        self.cl = cfg.conv_lookahead
        self.dl = cfg.df_lookahead
        self.D = max(self.cl, self.dl)
        self.do = cfg.df_order
        self.S = max(self.D + 1, self.D - self.dl + self.do)
        self.Dc = self.D - self.cl + 1
        for k, v in model.params.items():
            if ".convt" in k and k.endswith(".0.weight") and v.shape[2] != 1:
                raise ValueError(f"{k}: streaming needs time-pointwise transposed convs, "
                                 f"kernel {tuple(v.shape[2:])}")
        self.reset()

    @torch.inference_mode()
    def reset(self):
        """Start a new stream: norm states at ``init / a`` (so that the first
        hop's update gives offline's undecayed init), every buffer zero."""
        m, cfg = self.model, self.model.config
        dev, a, f = m.device, m.norm_alpha, cfg.freq_bins
        self.state = {
            "norm_erb": _norm_init(-60.0, -90.0, cfg.nb_erb, dev) / a,
            "norm_unit": _norm_init(0.001, 0.0001, cfg.nb_df, dev) / a,
            "spec_buf": torch.zeros((2 * self.S, f, 2), device=dev),
            "gain_buf": torch.zeros((self.Dc, f), device=dev),
            "coef_buf": torch.zeros((self.Dc, cfg.nb_df, self.do, 2), device=dev),
            "tails": {},
            "grus": {},
            "ola_sig": torch.zeros((cfg.fft_size,), device=dev),
            "ola_wsq": torch.zeros((cfg.fft_size,), device=dev),
        }
        self._zero_feats = (torch.zeros((cfg.nb_erb,), device=dev),
                            torch.zeros((cfg.nb_df, 2), device=dev),
                            torch.zeros((f, 2), device=dev))
        self._s = 0  # hops stepped (the spectrum's frame index)
        self._buf = np.zeros(cfg.hop_size, np.float32)  # offline's leading hop of zeros
        self._fed = 0
        self._emitted = 0
        self._skip = cfg.fft_size - cfg.hop_size  # offline's delay cut
        self._stage_times: dict[str, list[float]] = {
            "frame_prep": [], "device_steps": [], "collect": []}

    # -- one frame of the network (``_net`` at T = 1) -------------------------

    def _net_frame(self, feat_erb: torch.Tensor, feat_df: torch.Tensor, tails: dict,
                   grus: dict):
        m, cfg = self.model, self.model.config
        ts = _TailStore(tails)
        x_erb = feat_erb.reshape(1, 1, 1, cfg.nb_erb).to(m.dtype)
        x_df = feat_df.t().reshape(1, 2, 1, cfg.nb_df).to(m.dtype)
        gains, coefs, grus = m._net(
            x_erb, x_df, lambda name, x, fs: ts.conv(m.params, name, x, fs), grus)
        return (gains.reshape(cfg.freq_bins).to(torch.float32),
                coefs.reshape(cfg.nb_df, self.do, 2).to(torch.float32), ts.tails, grus)

    # -- one hop --------------------------------------------------------------

    def _step_impl(self, frame: torch.Tensor | None, is_flush: bool) -> torch.Tensor | None:
        """Advance one hop on ``frame [fft]`` (a flush hop: zero features and
        spectrum, the norm states kept) -> the hop's ``hop`` output samples,
        or None before the first output frame (``s < D``)."""
        m, cfg, st = self.model, self.model.config, self.state
        a, s, ndf = m.norm_alpha, self._s, cfg.nb_df
        if is_flush:
            feat_erb, feat_df, spec_frame = self._zero_feats
        else:
            spec = torch.view_as_real(torch.fft.rfft(frame * m.window) * m.wnorm)  # [F, 2]
            power = (spec * spec).sum(-1)
            erb_db = 10.0 * torch.log10(power @ m.erb_fb + 1e-10)
            st["norm_erb"] = a * st["norm_erb"] + (1 - a) * erb_db
            feat_erb = (erb_db - st["norm_erb"]) / 40.0
            st["norm_unit"] = a * st["norm_unit"] + (1 - a) * torch.sqrt(power[:ndf])
            feat_df = spec[:ndf] / torch.sqrt(torch.clamp(st["norm_unit"], min=1e-12))[:, None]
            spec_frame = spec
        ring = st["spec_buf"].view(2, self.S, cfg.freq_bins, 2)
        ring[:, s % self.S].copy_(spec_frame.expand(2, cfg.freq_bins, 2))

        if s >= self.cl:
            # offline's lookahead shift drops the first cl frames from the
            # network: hop s is the network's frame s - cl
            gains, coefs, st["tails"], st["grus"] = self._net_frame(
                feat_erb, feat_df, st["tails"], st["grus"])
            st["gain_buf"][s % self.Dc].copy_(gains)
            st["coef_buf"][s % self.Dc].copy_(coefs)
        if s < self.D:
            return None
        # output frame t = s - D: the gains and taps of hop s - (Dc - 1)
        gains_t = st["gain_buf"][(s + 1) % self.Dc]
        coefs_t = st["coef_buf"][(s + 1) % self.Dc]
        masked = st["spec_buf"][(s - self.D) % self.S] * gains_t[:, None]
        # the deep filter's window: frames t - do + 1 + dl .. t + dl
        w0 = (s - (self.D - self.dl) - self.do + 1) % self.S
        win = st["spec_buf"][w0: w0 + self.do, :ndf]  # [do, nb_df, 2]
        sr, si = win[..., 0], win[..., 1]
        cr, ci = coefs_t[..., 0].t(), coefs_t[..., 1].t()  # [do, nb_df]
        low = torch.stack([(sr * cr - si * ci).sum(0), (sr * ci + si * cr).sum(0)], dim=-1)
        enhanced = torch.cat([low, masked[ndf:]], dim=0)

        # synthesis: irfft, window, overlap-add, normalise the hop's samples
        wav = dsp.irfft(torch.view_as_complex(enhanced) / m.wnorm, n=cfg.fft_size) * m.window
        hop = cfg.hop_size
        sig = st["ola_sig"] + wav
        wsq = st["ola_wsq"] + m.window * m.window
        out = sig[:hop] / torch.clamp(wsq[:hop], min=1e-11)
        st["ola_sig"] = F.pad(sig[hop:], (0, hop))
        st["ola_wsq"] = F.pad(wsq[hop:], (0, hop))
        return torch.clamp(out, -1.0, 1.0)

    def _run_frames(self, frames: torch.Tensor | None, n_flush: int = 0) -> torch.Tensor | None:
        """Step ``frames [n, fft]`` (on the device), then ``n_flush`` flush
        hops, with no host read -> the output hops ``[k, hop]`` still on the
        device, or None."""
        outs = []
        n = 0 if frames is None else frames.shape[0]
        with torch.inference_mode(), nn.f32_convolutions():
            for i in range(n + n_flush):
                out = self._step_impl(frames[i] if i < n else None, i >= n)
                self._s += 1
                if out is not None:
                    outs.append(out)
            return torch.stack(outs) if outs else None

    def _frames(self) -> torch.Tensor | None:
        """Cut the whole frames out of the host buffer (each ``hop`` apart)
        and upload them at once."""
        cfg = self.model.config
        frames = []
        while len(self._buf) >= cfg.fft_size:
            frames.append(self._buf[: cfg.fft_size])
            self._buf = self._buf[cfg.hop_size:]
        if not frames:
            return None
        return torch.from_numpy(np.stack(frames)).to(self.model.device)

    # -- public API ---------------------------------------------------------

    def process_chunk(self, samples) -> np.ndarray:
        """Feed any number of samples; returns the enhanced samples that
        became final (``D`` hops behind the input)."""
        t0 = time.perf_counter()
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._fed += len(samples)
        self._buf = np.concatenate([self._buf, samples])
        frames = self._frames()
        t1 = time.perf_counter()
        out = self._run_frames(frames)
        t2 = time.perf_counter()
        result = self._collect(out)
        t3 = time.perf_counter()
        self._stage_times["frame_prep"].append(t1 - t0)
        self._stage_times["device_steps"].append(t2 - t1)
        self._stage_times["collect"].append(t3 - t2)
        return result

    def _collect(self, out: torch.Tensor | None) -> np.ndarray:
        """The chunk's one readback, less offline's ``fft - hop`` delay at the
        stream's start and anything past the samples fed."""
        if out is None:
            return np.zeros(0, np.float32)
        chunk = out.cpu().numpy().reshape(-1)
        if self._skip > 0:
            drop = min(self._skip, len(chunk))
            chunk = chunk[drop:]
            self._skip -= drop
        remaining = self._fed - self._emitted
        chunk = chunk[: max(0, remaining)]
        self._emitted += len(chunk)
        return chunk

    def flush(self) -> np.ndarray:
        """The stream's end: ``fft_size`` zeros after the input and more to
        whole frames (offline's tail padding: its last frame holds no audio,
        but its features are not zero), then ``D`` flush hops to drain the
        lookahead. Returns the remaining samples."""
        cfg = self.model.config
        t0 = time.perf_counter()
        tail = cfg.fft_size + (-len(self._buf)) % cfg.hop_size
        self._buf = np.concatenate([self._buf, np.zeros(tail, np.float32)])
        result = self._collect(self._run_frames(self._frames(), self.D))
        self._stage_times["device_steps"].append(time.perf_counter() - t0)
        return result

    def profiling_summary(self) -> str:
        """Wall time a stage a hop: ``frame_prep`` (host framing and the
        frames' upload), ``device_steps`` (enqueueing the hops, no host
        read), ``collect`` (the readback, which waits for the device)."""
        cfg = self.model.config
        hop_ms = 1000.0 * cfg.hop_size / cfg.sample_rate
        lines = [f"DeepFilterNet streaming profile "
                 f"({self._s} hops, budget {hop_ms:.1f} ms/hop):"]
        for stage, ts in self._stage_times.items():
            if not ts:
                continue
            tot = sum(ts)
            per_hop = 1000.0 * tot / max(1, self._s)
            lines.append(f"  {stage:>12}: total {tot*1e3:8.1f} ms, "
                         f"{per_hop:6.2f} ms/hop")
        return "\n".join(lines)
