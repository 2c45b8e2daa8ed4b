"""Parakeet (NeMo FastConformer) STT on the PyTorch port: TDT / RNNT / CTC
variants with a batched decode loop on the device.

Port of tpu_audio.models.stt.parakeet, with the same semantics on every
route:

- NeMo log-mel frontend: preemphasis, constant-pad STFT with a symmetric
  window zero-padded to n_fft, slaney mel, log + guard, per-feature
  mean/std normalization (``T - 1`` denominator).
- FastConformer encoder: depthwise-striding 2D subsampling, conformer
  blocks with half-step FFNs, GLU conv module with BatchNorm, and
  Transformer-XL style relative-position attention with pos_bias_u/v and
  rel-shift. Both score products take f32 operands and the softmax runs in
  f32; the probabilities are cast to the activation dtype before ``p @ v``.
  A batch's mel frames are padded to a power-of-two bucket (at least 64)
  and the attention has no mask, so valid frames attend to padded ones, as
  in the JAX package: the bucket is part of the function.
- TDT/RNNT decode (:class:`TDTDecoder`): the JAX package's one
  ``lax.while_loop`` over the batch as torch steps with the same masked
  arithmetic on the device (per-row time cursors, LSTM prediction network,
  additive joint; state and last token committed only on emission; RNNT as
  TDT with ``jump = (token == blank)``). The host reads the stop condition
  ``any(time < lengths)`` every ``core.ar_loop.SYNC_EVERY`` steps and the
  lattice once at the end; a step taken after every row has finished
  changes nothing, since each row's ``active`` mask holds it.
- CTC decode: argmax + collapse.

On an MLX 4/8-bit tree the joint's three products run at B rows a decode
step through ``ops.qmm.quantized_matvec`` (kernel 7 on CUDA). A packed
prediction embedding dequantizes its rows to f32, and the LSTM state is
then carried in f32 from the first step (the JAX package raises there in
bf16: its loop starts the state in the features' dtype).

Checkpoints are the MLX-community conversions: the same key remaps
(pre_encode conv-list renumbering, joint_net.2 flattening, pos_bias naming)
plus layout transposes to torch conventions (:func:`sanitize`).
"""

from __future__ import annotations

import functools
import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from tpu_audio_torch.core import dsp, hub, loading, nn, quant
from tpu_audio_torch.core.ar_loop import SYNC_EVERY
from tpu_audio_torch.core.generation import STTGenerateParameters, STTOutput, STTSegment
from tpu_audio_torch.models.stt import nemo_alignment

__all__ = ["Parakeet", "ParakeetConfig", "PreprocessConfig", "ConformerConfig",
           "TDTDecoder", "log_mel_spectrogram", "encoder_forward",
           "sanitize", "init_random_params"]


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclass
class PreprocessConfig:
    sample_rate: int = 16000
    normalize: str = "per_feature"
    window_size: float = 0.025
    window_stride: float = 0.01
    window: str = "hann"
    features: int = 80
    n_fft: int = 512
    pad_to: int = 0
    pad_value: float = 0.0
    preemph: float = 0.97
    log_zero_guard_value: float = 2.0**-24


@dataclass
class ConformerConfig:
    feat_in: int = 80
    n_layers: int = 17
    d_model: int = 512
    n_heads: int = 8
    ff_expansion_factor: int = 4
    subsampling_factor: int = 8
    self_attention_model: str = "rel_pos"
    subsampling: str = "dw_striding"
    conv_kernel_size: int = 9
    subsampling_conv_channels: int = 256
    pos_emb_max_len: int = 5000
    causal_downsampling: bool = False
    use_bias: bool = True
    xscaling: bool = False


@dataclass
class ParakeetConfig:
    variant: str = "tdt"  # tdt | rnnt | ctc | tdt_ctc
    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)
    encoder: ConformerConfig = field(default_factory=ConformerConfig)
    vocabulary: list[str] = field(default_factory=list)
    durations: list[int] = field(default_factory=lambda: [0, 1, 2, 3, 4])
    max_symbols: int | None = 10
    pred_hidden: int = 640
    pred_rnn_layers: int = 1
    joint_hidden: int = 640
    joint_activation: str = "relu"
    num_extra_outputs: int = 0
    quantization: dict | None = None

    @property
    def blank_token(self) -> int:
        return len(self.vocabulary)

    @classmethod
    def from_dict(cls, d: dict) -> "ParakeetConfig":
        """The variant rule of the JAX package: durations make ``tdt``
        (``tdt_ctc`` with an ``aux_ctc`` block), a joint network without
        them ``rnnt``, neither ``ctc``."""
        pp = {k: v for k, v in d.get("preprocessor", {}).items()
              if k in PreprocessConfig.__dataclass_fields__}
        enc = {k: v for k, v in d.get("encoder", {}).items()
               if k in ConformerConfig.__dataclass_fields__}
        cfg = cls(preprocess=PreprocessConfig(**pp), encoder=ConformerConfig(**enc))
        joint = d.get("joint") or {}
        dec = d.get("decoder") or {}
        decoding = d.get("decoding") or {}
        defaults = d.get("model_defaults") or {}
        cfg.vocabulary = joint.get("vocabulary") or dec.get("vocabulary") or []
        durations = decoding.get("durations") or defaults.get("tdt_durations")
        has_joint = bool(joint.get("jointnet"))
        if durations:
            cfg.variant = "tdt_ctc" if d.get("aux_ctc") else "tdt"
            cfg.durations = list(durations)
        elif has_joint:
            cfg.variant = "rnnt"
            cfg.durations = []
        else:
            cfg.variant = "ctc"
            cfg.durations = []
        greedy = decoding.get("greedy") or {}
        cfg.max_symbols = greedy.get("max_symbols", 10)
        prednet = dec.get("prednet") or {}
        cfg.pred_hidden = prednet.get("pred_hidden", cfg.pred_hidden)
        cfg.pred_rnn_layers = prednet.get("pred_rnn_layers", 1)
        jointnet = joint.get("jointnet") or {}
        cfg.joint_hidden = jointnet.get("joint_hidden", cfg.joint_hidden)
        cfg.joint_activation = jointnet.get("activation", "relu")
        cfg.num_extra_outputs = joint.get("num_extra_outputs", 0)
        cfg.quantization = d.get("quantization")
        return cfg


# ---------------------------------------------------------------------------
# Audio frontend
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _make_window(name: str, win_length: int, n_fft: int) -> np.ndarray:
    name = name.lower()
    if name in ("hann", "hanning"):
        base = dsp.hanning_window(win_length, periodic=False)
    elif name == "hamming":
        base = dsp.hamming_window(win_length, periodic=False)
    elif name == "blackman":
        n = np.arange(win_length)
        k = 2 * np.pi * n / (win_length - 1)
        base = (0.42 - 0.5 * np.cos(k) + 0.08 * np.cos(2 * k)).astype(np.float32)
    elif name == "bartlett":
        base = np.bartlett(win_length).astype(np.float32)
    else:
        base = dsp.hanning_window(win_length, periodic=False)
    if win_length >= n_fft:
        return base[:n_fft]
    left = (n_fft - win_length) // 2
    return np.pad(base, (left, n_fft - win_length - left))


def _log_mel(audio: torch.Tensor, cfg: PreprocessConfig) -> torch.Tensor:
    """1D f32 audio -> normalized log-mel ``[T, n_mels]`` on its device."""
    x = audio.to(torch.float32)
    if cfg.preemph > 0:
        x = torch.cat([x[:1], x[1:] - float(cfg.preemph) * x[:-1]])
    n_fft = cfg.n_fft
    window = _make_window(cfg.window, int(cfg.window_size * cfg.sample_rate), n_fft)
    spec = dsp.stft(x, window, n_fft, int(cfg.window_stride * cfg.sample_rate),
                    pad_mode="constant")
    power = spec.abs() ** 2  # [T, F]
    filters = torch.from_numpy(dsp.mel_filters(cfg.sample_rate, n_fft, cfg.features,
                                               norm="slaney", mel_scale="slaney")).to(x.device)
    mel = torch.log(power @ filters + float(cfg.log_zero_guard_value))
    if cfg.normalize == "per_feature":
        mean = mel.mean(0, keepdim=True)
        denom = max(mel.shape[0] - 1, 1)
        var = ((mel - mean) ** 2).sum(0, keepdim=True) / denom
        mel = (mel - mean) / (torch.sqrt(var) + 1e-5)
    else:
        mel = (mel - mel.mean()) / (mel.std(correction=0) + 1e-5)
    return mel


def log_mel_spectrogram(audio, cfg: PreprocessConfig, device=None) -> torch.Tensor:
    """NeMo-style normalized log-mel ``[1, T, n_mels]`` (f32) of a 1D array,
    computed on ``device`` (default: the CPU)."""
    audio = np.asarray(audio, np.float32).reshape(-1)
    if cfg.pad_to > 0 and audio.shape[0] < cfg.pad_to:
        audio = np.pad(audio, (0, cfg.pad_to - audio.shape[0]),
                       constant_values=cfg.pad_value)
    x = torch.from_numpy(np.ascontiguousarray(audio)).to(device or "cpu")
    return _log_mel(x, cfg)[None]


# ---------------------------------------------------------------------------
# Conformer encoder
# ---------------------------------------------------------------------------


def _subsample(p, x, lengths, cfg: ConformerConfig):
    """dw_striding subsampling: ``[B, T, F] -> [B, T/sf, d_model]`` and the
    lengths by the ``floor`` rule."""
    sampling_num = int(math.log2(cfg.subsampling_factor))
    out_len = lengths.to(torch.float32)
    for _ in range(sampling_num):
        out_len = torch.floor((out_len + 2 * 1 - 3) / 2) + 1
    out_len = out_len.to(torch.int32)

    y = x[..., None]  # [B, T, F, 1]
    y = torch.relu(nn.conv2d(p["conv0"], y, stride=(2, 2), padding=(1, 1)))
    ch = cfg.subsampling_conv_channels
    for i in range(sampling_num - 1):
        y = nn.conv2d(p["depthwise_layers"][str(i)], y, stride=(2, 2), padding=(1, 1),
                      groups=ch)
        y = torch.relu(nn.conv2d(p["pointwise_layers"][str(i)], y))
    b, t, f, c = y.shape
    y = y.permute(0, 1, 3, 2).reshape(b, t, c * f)
    return nn.linear(p["out"], y), out_len


@functools.lru_cache(maxsize=16)
def _rel_pos_encoding(length: int, d_model: int) -> np.ndarray:
    """Relative positional embeddings ``[1, 2L-1, d]`` centered at position
    0 (float64 angles, f32 table)."""
    rows = 2 * length - 1
    pos = (length - 1 - np.arange(rows))[:, None].astype(np.float64)
    div = np.exp(-np.arange(0, d_model, 2) * math.log(10000.0) / d_model)
    pe = np.zeros((rows, d_model), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe[None]


def _rel_shift(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, Tq, P]`` Transformer-XL relative shift."""
    b, h, tq, p = x.shape
    x = torch.nn.functional.pad(x, (1, 0))
    x = x.reshape(b, h, p + 1, tq)[:, :, 1:]
    return x.reshape(b, h, tq, p)


def _rel_pos_attention(p, x, pos_emb, n_heads: int):
    b, t, d = x.shape
    hd = d // n_heads
    scale = hd**-0.5
    q = nn.linear(p["linear_q"], x).reshape(b, t, n_heads, hd)
    k = nn.linear(p["linear_k"], x).reshape(b, t, n_heads, hd).transpose(1, 2)
    v = nn.linear(p["linear_v"], x).reshape(b, t, n_heads, hd).transpose(1, 2)
    pp = nn.linear(p["linear_pos"], pos_emb.to(x.dtype))
    pos_len = pp.shape[1]
    ph = pp.reshape(1, pos_len, n_heads, hd).transpose(1, 2)

    q_u = (q + p["posBiasU"].to(x.dtype)).transpose(1, 2)
    q_v = (q + p["posBiasV"].to(x.dtype)).transpose(1, 2)

    # bf16 operands, f32 products (the JAX package's preferred_element_type)
    bd = q_v.float() @ ph.float().transpose(-1, -2)
    bd = _rel_shift(bd)[..., :t] * scale
    ac = (q_u.float() @ k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(ac + bd, dim=-1).to(x.dtype)
    o = probs @ v
    o = o.transpose(1, 2).reshape(b, t, d)
    return nn.linear(p["linear_out"], o)


def _conformer_conv(p, x, kernel_size: int, norm: str = "batch_norm"):
    """The conformer's GLU conv module; ``norm`` names its BatchNorm subtree
    (Sortformer's checkpoints call it ``norm``)."""
    pw = nn.conv1d(p["pointwise_conv1"], x)
    a, g = pw.chunk(2, dim=-1)
    y = a * torch.sigmoid(g)
    y = nn.conv1d(p["depthwise_conv"], y, padding=(kernel_size - 1) // 2,
                  groups=y.shape[-1])
    y = nn.silu(nn.batch_norm(p[norm], y))
    return nn.conv1d(p["pointwise_conv2"], y)


def _ff(p, x):
    return nn.linear(p["linear2"], nn.silu(nn.linear(p["linear1"], x)))


def _conformer_block(p, x, pos_emb, cfg: ConformerConfig):
    x = x + 0.5 * _ff(p["feed_forward1"], nn.layer_norm(p["norm_feed_forward1"], x))
    h = nn.layer_norm(p["norm_self_att"], x)
    x = x + _rel_pos_attention(p["self_attn"], h, pos_emb, cfg.n_heads)
    x = x + _conformer_conv(p["conv"], nn.layer_norm(p["norm_conv"], x),
                            cfg.conv_kernel_size)
    x = x + 0.5 * _ff(p["feed_forward2"], nn.layer_norm(p["norm_feed_forward2"], x))
    return nn.layer_norm(p["norm_out"], x)


def encoder_forward(params, mel, lengths, cfg: ConformerConfig):
    """mel ``[B, T, F]`` -> (features ``[B, T/sf, d_model]``, out_lengths
    ``[B]`` int32)."""
    p = params["encoder"]
    x, out_len = _subsample(p["pre_encode"], mel, lengths, cfg)
    xscale = math.sqrt(cfg.d_model) if cfg.xscaling else 1.0
    if cfg.self_attention_model == "rel_pos":
        pos_emb = torch.from_numpy(_rel_pos_encoding(x.shape[1], cfg.d_model)).to(x.device)
        x = x * xscale
    else:
        pos_emb = None
    for i in range(cfg.n_layers):
        x = _conformer_block(p["layers"][str(i)], x, pos_emb, cfg)
    return x, out_len


# ---------------------------------------------------------------------------
# Prediction + joint
# ---------------------------------------------------------------------------


def prediction_dtype(params, dtype: torch.dtype) -> torch.dtype:
    """The dtype of the prediction network's input and LSTM state: f32
    where the embedding is packed (its rows dequantize to f32), else the
    table's own dtype (``dtype`` if it has none)."""
    w = params["decoder"]["prediction"]["embed"]["weight"]
    if isinstance(w, (quant.QuantizedTensor, quant.Int8Tensor)):
        return torch.float32
    return w.dtype if isinstance(w, torch.Tensor) else dtype


def _predict_step(params, tokens, h, c, cfg: ParakeetConfig):
    """One LSTM prediction-network step. tokens ``[B]`` (blank -> zero
    embedding); h/c ``[L, B, H]``."""
    p = params["decoder"]["prediction"]
    is_blank = tokens == cfg.blank_token
    emb = nn.embedding(p["embed"], torch.where(is_blank, 0, tokens).long())
    x = emb.masked_fill(is_blank[:, None], 0.0)
    hs, cs = [], []
    for i in range(cfg.pred_rnn_layers):
        h_i, c_i = nn.lstm_cell(p["dec_rnn"]["lstm"][str(i)], x, h[i], c[i])
        x = h_i
        hs.append(h_i)
        cs.append(c_i)
    return x, torch.stack(hs), torch.stack(cs)


def _joint(params, enc_frame, pred, cfg: ParakeetConfig):
    """Additive joint: enc ``[B, D]``, pred ``[B, H]`` -> logits ``[B,
    classes]``."""
    p = params["joint"]
    x = nn.linear(p["enc"], enc_frame) + nn.linear(p["pred"], pred)
    act = cfg.joint_activation.lower()
    if act == "relu":
        x = torch.relu(x)
    elif act == "sigmoid":
        x = torch.sigmoid(x)
    else:
        x = torch.tanh(x)
    return nn.linear(p["joint_net"], x)


# ---------------------------------------------------------------------------
# TDT / RNNT decode: one masked loop for the whole batch
# ---------------------------------------------------------------------------


class TDTDecoder:
    """The batched TDT/RNNT greedy decode loop for buffers of ``max_emit``
    emissions a row. ``decoder(params, features [B, T, D], lengths [B])``
    returns host arrays ``(tokens, times, jumps)`` ``[B, max_emit]`` and
    ``counts [B]`` (int32). Its steps run in chunks of ``SYNC_EVERY``
    (:meth:`steps`, no host sync inside), with one host read of the stop
    condition before each chunk and one of the lattice at the end;
    ``stats`` holds the last call's steps and host reads. With ``trace`` a
    list, every step appends its device tensors ``(time, active, token,
    jump, logits)`` to it."""

    def __init__(self, cfg: ParakeetConfig, max_emit: int):
        self.cfg = cfg
        self.max_emit = max_emit
        self.stats = {"steps": 0, "reads": 0}

    def init_state(self, params, features):
        cfg = self.cfg
        b = features.shape[0]
        dev = features.device
        sdt = prediction_dtype(params, features.dtype)
        zeros = torch.zeros((cfg.pred_rnn_layers, b, cfg.pred_hidden), dtype=sdt, device=dev)
        return dict(
            time=torch.zeros((b,), dtype=torch.int32, device=dev),
            new_sym=torch.zeros((b,), dtype=torch.int32, device=dev),
            last_tok=torch.full((b,), cfg.blank_token, dtype=torch.int32, device=dev),
            h=zeros, c=zeros.clone(),
            # per-row (token, time, jump) of each emission, and the counts
            lattice=torch.zeros((b, self.max_emit, 3), dtype=torch.int32, device=dev),
            counts=torch.zeros((b,), dtype=torch.int32, device=dev),
            durations=(torch.tensor(cfg.durations, dtype=torch.int32, device=dev)
                       if cfg.durations else None))

    def step(self, params, features, lengths, st: dict, trace: list | None = None) -> None:
        """One decode step of every row, in place on ``st``."""
        cfg = self.cfg
        blank = cfg.blank_token
        b, t_max, d = features.shape
        time_, new_sym = st["time"], st["new_sym"]
        active = time_ < lengths
        at = time_.clamp(0, t_max - 1).long()
        frame = features.gather(1, at[:, None, None].expand(b, 1, d))[:, 0]
        pred, h_new, c_new = _predict_step(params, st["last_tok"], st["h"], st["c"], cfg)
        logits = _joint(params, frame, pred.to(features.dtype), cfg).to(torch.float32)
        tok = logits[:, : blank + 1].argmax(-1).to(torch.int32)
        if st["durations"] is not None:
            jump = st["durations"][logits[:, blank + 1 :].argmax(-1)]
        else:
            jump = (tok == blank).to(torch.int32)  # RNNT
        if trace is not None:
            trace.append((time_, active, tok, jump, logits))
        # the TDT reduction (NemoDecodingLogic.tdtStep)
        next_time = time_ + jump
        next_new = torch.where(jump != 0, 0, new_sym + 1)
        if cfg.max_symbols is not None:
            hit = (jump == 0) & (next_new >= cfg.max_symbols)
            next_time = next_time + hit.to(torch.int32)
            next_new = torch.where(hit, 0, next_new)
        commit = active & (tok != blank)
        # the LSTM state and the last token move only on emission
        st["h"] = torch.where(commit[None, :, None], h_new, st["h"])
        st["c"] = torch.where(commit[None, :, None], c_new, st["c"])
        st["last_tok"] = torch.where(commit, tok, st["last_tok"])
        lattice = st["lattice"]
        pos = st["counts"].clamp(0, self.max_emit - 1).long()[:, None, None].expand(b, 1, 3)
        new = torch.stack([tok, time_, jump], dim=-1)[:, None]
        lattice.scatter_(1, pos, torch.where(commit[:, None, None], new, lattice.gather(1, pos)))
        st["counts"] = st["counts"] + commit.to(torch.int32)
        st["time"] = torch.where(active, next_time, time_)
        st["new_sym"] = torch.where(active, next_new, new_sym)

    def steps(self, params, features, lengths, st: dict, n: int,
              trace: list | None = None) -> None:
        """``n`` steps with no host read between them."""
        for _ in range(n):
            self.step(params, features, lengths, st, trace)

    def __call__(self, params, features, lengths, trace: list | None = None):
        st = self.init_state(params, features)
        steps = reads = 0
        while True:
            reads += 1
            if not bool((st["time"] < lengths).any()):
                break
            self.steps(params, features, lengths, st, SYNC_EVERY, trace)
            steps += SYNC_EVERY
        b = features.shape[0]
        out = torch.cat([st["counts"][:, None], st["lattice"].reshape(b, -1)], 1)
        out = out.cpu().numpy()
        self.stats = {"steps": steps, "reads": reads + 1}
        lat = out[:, 1:].reshape(b, self.max_emit, 3)
        return lat[..., 0], lat[..., 1], lat[..., 2], out[:, 0]


# ---------------------------------------------------------------------------
# Sanitize (MLX-community layout -> the tree the model reads)
# ---------------------------------------------------------------------------


def sanitize(weights: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Key remaps and layout transposes of an MLX-community checkpoint:
    conv2d ``[O, H, W, I] -> [O, I, H, W]``, conv1d ``[O, K, I] -> [O, I,
    K]``, MLX LSTM names (``Wx``/``Wh``, one ``bias`` -> ``bias_ih``)."""
    out = {}
    for key, v in weights.items():
        k = key
        k = k.replace(".decoder_layers.0.", ".decoder_layers.")
        k = k.replace("joint.joint_net.2.", "joint.joint_net.")
        k = k.replace(".pos_bias_u", ".posBiasU")
        k = k.replace(".pos_bias_v", ".posBiasV")
        # pre_encode conv-list renumbering
        parts = k.split(".")
        if (len(parts) >= 5 and parts[0] == "encoder" and parts[1] == "pre_encode"
                and parts[2] == "conv" and parts[3].isdigit()):
            idx = int(parts[3])
            suffix = ".".join(parts[4:])
            if idx == 0:
                k = f"encoder.pre_encode.conv0.{suffix}"
            elif idx >= 2:
                sh = idx - 2
                if sh % 3 == 0:
                    k = f"encoder.pre_encode.depthwise_layers.{sh // 3}.{suffix}"
                elif sh % 3 == 1:
                    k = f"encoder.pre_encode.pointwise_layers.{sh // 3}.{suffix}"
                else:
                    continue  # ReLU placeholder
            else:
                continue
        if k.endswith(".weight") and v.ndim == 4:
            v = v.permute(0, 3, 1, 2).contiguous()
        elif (k.endswith(".weight") and v.ndim == 3
              and ("conv" in k or "decoder_layers" in k)):
            v = v.permute(0, 2, 1).contiguous()
        k = k.replace(".Wx", ".weight_ih").replace(".Wh", ".weight_hh")
        out[k] = v
    renamed = {}
    for k, v in out.items():
        parts = k.split(".")
        if len(parts) >= 3 and parts[-1] == "bias" and parts[-3] == "lstm" \
                and parts[-2].isdigit():
            renamed[".".join(parts[:-1]) + ".bias_ih"] = v
        else:
            renamed[k] = v
    return renamed


def init_random_params(cfg: ParakeetConfig, seed: int = 0, dtype=torch.bfloat16,
                       device=None) -> dict:
    """Random params in the sanitized tree's layout at any width, drawn on
    ``device`` from a ``torch.Generator``: N(0, 1/fan_in) weights, the
    output projection of each residual branch (FFN ``linear2``, attention
    ``linear_out``, conv ``pointwise_conv2``) scaled by ``1/sqrt(2 *
    n_layers)`` so that the input still shapes the features after every
    layer (at full scale 24 random attention layers average the frames into
    one), N(0, 0.02) biases and position biases, N(0, 0.5) embeddings, unit
    norms and BatchNorm statistics (zero mean, unit variance)."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    gen = torch.Generator(device=device).manual_seed(seed)
    enc = cfg.encoder

    def rand(*shape, std=None):
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        s = std if std is not None else fan_in ** -0.5
        return (torch.randn(shape, generator=gen, device=device) * s).to(dtype)

    def lin(o, i, bias=True, gain=1.0):
        p = {"weight": rand(o, i, std=gain * i ** -0.5)}
        if bias:
            p["bias"] = rand(o, std=0.02)
        return p

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    d, ch, h = enc.d_model, enc.subsampling_conv_channels, enc.n_heads
    sampling_num = int(math.log2(enc.subsampling_factor))
    f_out = enc.feat_in
    for _ in range(sampling_num):
        f_out = (f_out + 2 - 3) // 2 + 1
    pre = {"conv0": {"weight": rand(ch, 1, 3, 3), "bias": rand(ch, std=0.02)},
           "depthwise_layers": {str(i): {"weight": rand(ch, 1, 3, 3), "bias": rand(ch, std=0.02)}
                                for i in range(sampling_num - 1)},
           "pointwise_layers": {str(i): {"weight": rand(ch, ch, 1, 1), "bias": rand(ch, std=0.02)}
                                for i in range(sampling_num - 1)},
           "out": lin(d, ch * f_out)}
    ff = enc.ff_expansion_factor * d
    branch = (2 * enc.n_layers) ** -0.5  # each residual branch's output projection
    layers = {}
    for i in range(enc.n_layers):
        norms = {n: {"weight": ones(d), "bias": zeros(d)}
                 for n in ("norm_feed_forward1", "norm_self_att", "norm_conv",
                           "norm_feed_forward2", "norm_out")}
        layers[str(i)] = {
            **norms,
            "feed_forward1": {"linear1": lin(ff, d), "linear2": lin(d, ff, gain=branch)},
            "feed_forward2": {"linear1": lin(ff, d), "linear2": lin(d, ff, gain=branch)},
            "self_attn": {**{n: lin(d, d) for n in ("linear_q", "linear_k", "linear_v")},
                          "linear_out": lin(d, d, gain=branch),
                          "linear_pos": lin(d, d, bias=False),
                          "posBiasU": rand(h, d // h, std=0.02),
                          "posBiasV": rand(h, d // h, std=0.02)},
            "conv": {"pointwise_conv1": {"weight": rand(2 * d, d, 1), "bias": rand(2 * d, std=0.02)},
                     "depthwise_conv": {"weight": rand(d, 1, enc.conv_kernel_size),
                                        "bias": rand(d, std=0.02)},
                     "pointwise_conv2": {"weight": rand(d, d, 1, std=branch * d ** -0.5),
                                         "bias": rand(d, std=0.02)},
                     "batch_norm": {"weight": ones(d), "bias": zeros(d),
                                    "running_mean": zeros(d), "running_var": ones(d)}},
        }
    v, ph, j = len(cfg.vocabulary), cfg.pred_hidden, cfg.joint_hidden
    lstm = {str(i): {"weight_ih": rand(4 * ph, ph), "weight_hh": rand(4 * ph, ph),
                     "bias_ih": rand(4 * ph, std=0.02)}
            for i in range(cfg.pred_rnn_layers)}
    params = {"encoder": {"pre_encode": pre, "layers": layers},
              "decoder": {"prediction": {"embed": {"weight": rand(v + 1, ph, std=0.5)},
                                         "dec_rnn": {"lstm": lstm}}},
              "joint": {"enc": lin(j, d), "pred": lin(j, ph),
                        "joint_net": lin(v + 1 + len(cfg.durations), j)}}
    if "ctc" in cfg.variant:
        params["ctc_decoder"] = {"decoder_layers": {"weight": rand(v + 1, d, 1),
                                                    "bias": rand(v + 1, std=0.02)}}
    return params


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


def _first_device(tree) -> torch.device:
    if isinstance(tree, dict):
        for v in tree.values():
            dev = _first_device(v)
            if dev is not None:
                return dev
        return None
    if isinstance(tree, (quant.QuantizedTensor, quant.Int8Tensor)):
        return tree.weight.device
    return tree.device if isinstance(tree, torch.Tensor) else None


class Parakeet:
    """Parakeet with ``generate_batch`` / ``generate_batch_aligned`` /
    ``generate`` (long audio in merged chunks) / ``generate_stream``; it
    computes on its params' device in ``dtype``."""

    def __init__(self, config: ParakeetConfig, params, dtype=torch.bfloat16):
        self.config = config
        self.params = params
        self.dtype = dtype
        self.device = _first_device(params) or torch.device("cpu")
        self._decoders: dict[int, TDTDecoder] = {}

    @classmethod
    def from_pretrained(cls, repo_or_path: str, dtype=torch.bfloat16, device="cuda",
                        quantize=None) -> "Parakeet":
        """Load a local checkpoint directory onto ``device``; a
        ``quantization`` block makes its packed triples MLX
        :class:`quant.QuantizedTensor` leaves. ``quantize`` is accepted for
        ``load_model``'s callers: Parakeet has no load-time quantization, so
        any value but None raises."""
        if quantize is not None:
            raise ValueError(f"quantize={quantize!r}: Parakeet has no load-time "
                             "quantization (load an MLX-quantized checkpoint instead)")
        model_dir = hub.resolve_model_dir(repo_or_path)
        config = ParakeetConfig.from_dict(hub.load_config(model_dir))
        params = loading.load_params(model_dir, sanitize=sanitize, dtype=dtype,
                                     expected_prefixes=("encoder",))
        params = loading.to_device(params, device)
        if config.quantization:
            q = config.quantization
            params = quant.tag_quantized(params, q.get("group_size", 64), q.get("bits", 4))
        return cls(config, params, dtype)

    # -- pieces ---------------------------------------------------------------

    def _encode(self, params, mel, lengths):
        return encoder_forward(params, mel, lengths, self.config.encoder)

    def _ctc_logits(self, params, features):
        p = params["ctc_decoder"] if "ctc_decoder" in params else params["aux_ctc"]
        return nn.conv1d(p["decoder_layers"], features)

    def _frame_seconds(self, frame: int) -> float:
        cfg = self.config
        return frame * cfg.preprocess.window_stride * cfg.encoder.subsampling_factor

    def _token_text(self, token_id: int) -> str | None:
        """SentencePiece piece -> display text; None for special tokens."""
        vocab = self.config.vocabulary
        if not 0 <= token_id < len(vocab):
            return None
        piece = vocab[token_id]
        if piece.startswith("<") and piece.endswith(">"):
            return None
        return piece.replace("▁", " ")

    def _aligned_tokens(self, ids, starts, ends) -> list:
        """Lattice emissions -> AlignedTokens with absolute seconds."""
        out = []
        for tok, s, e in zip(ids, starts, ends):
            text = self._token_text(int(tok))
            if text is None:
                continue
            start = self._frame_seconds(int(s))
            out.append(nemo_alignment.AlignedToken(
                id=int(tok), text=text, start=start,
                duration=max(self._frame_seconds(int(e)) - start, 0.0)))
        return out

    @staticmethod
    def _result_to_segments(result) -> list[STTSegment]:
        return [
            STTSegment(text=s.text.strip(), start=s.start, end=s.end,
                       tokens=[t.id for t in s.tokens])
            for s in result.sentences
        ]

    def _get_decoder(self, max_emit: int) -> TDTDecoder:
        if max_emit not in self._decoders:
            self._decoders[max_emit] = TDTDecoder(self.config, max_emit)
        return self._decoders[max_emit]

    def mel_batch(self, audios: list) -> tuple[torch.Tensor, torch.Tensor]:
        """Each clip's log-mel on the device, padded with zeros to the
        batch's bucket of ``max(64, 2**ceil(log2 T_max))`` frames: ``[B,
        bucket, n_mels]`` in the model's dtype, and the frame counts ``[B]``
        (int32)."""
        cfg = self.config
        mels = [log_mel_spectrogram(a, cfg.preprocess, self.device)[0] for a in audios]
        t_max = max(m.shape[0] for m in mels)
        bucket = max(64, 1 << math.ceil(math.log2(max(t_max, 2))))
        batch = torch.zeros((len(mels), bucket, cfg.preprocess.features), dtype=torch.float32,
                            device=self.device)
        for i, m in enumerate(mels):
            batch[i, : m.shape[0]] = m
        lengths = torch.tensor([m.shape[0] for m in mels], dtype=torch.int32,
                               device=self.device)
        return batch.to(self.dtype), lengths

    def max_emit(self, n_frames: int, max_tokens: int) -> int:
        """The emission buffer a row for ``n_frames`` encoder frames: at
        most ``max_tokens``, in a power-of-two bucket of at least 64."""
        max_emit = min(max_tokens, n_frames * (self.config.max_symbols or 10))
        return max(64, 1 << math.ceil(math.log2(max(max_emit, 2))))

    # -- batch decode ---------------------------------------------------------

    def generate_batch(self, audios: list,
                       generation_parameters: STTGenerateParameters | None = None
                       ) -> list[STTOutput]:
        return self.generate_batch_aligned(audios, generation_parameters)[0]

    def generate_batch_aligned(
            self, audios: list,
            generation_parameters: STTGenerateParameters | None = None
    ) -> tuple[list[STTOutput], list[list]]:
        """Batch decode returning both STTOutputs and the per-utterance
        aligned token lists (timing from the TDT/CTC lattice) used by the
        long-audio overlap merge."""
        params = generation_parameters or STTGenerateParameters(max_tokens=8192)
        t0 = time.perf_counter()
        cfg = self.config
        batch, lengths = self.mel_batch(audios)
        feats, out_lens = self._encode(self.params, batch, lengths)

        if cfg.variant == "ctc":
            return self._generate_ctc(feats, out_lens, audios, t0)

        decode = self._get_decoder(self.max_emit(int(feats.shape[1]), params.max_tokens))
        toks, times, jumps, counts = decode(self.params, feats, out_lens)
        elapsed = time.perf_counter() - t0

        outputs, aligned_lists = [], []
        for i in range(len(audios)):
            n = int(counts[i])
            ids = toks[i, :n].tolist()
            aligned = self._aligned_tokens(
                ids, times[i, :n], times[i, :n] + np.maximum(jumps[i, :n], 1))
            aligned_lists.append(aligned)
            result = nemo_alignment.sentences_to_result(
                nemo_alignment.tokens_to_sentences(aligned))
            outputs.append(STTOutput(
                text=result.text, segments=self._result_to_segments(result),
                language=params.language,
                generation_token_count=n, total_time=elapsed,
                generation_time=elapsed,
            ))
        return outputs, aligned_lists

    def _generate_ctc(self, feats, out_lens, audios, t0):
        logits = self._ctc_logits(self.params, feats)
        best = logits.argmax(-1).cpu().numpy()
        out_lens = out_lens.cpu().numpy()
        blank = self.config.blank_token
        elapsed = time.perf_counter() - t0
        outputs, aligned_lists = [], []
        for i in range(len(audios)):
            seq = best[i, : int(out_lens[i])].tolist()
            # collapse repeats then remove blanks, keeping [start, end) frame
            # spans per emission
            ids, starts, ends = [], [], []
            prev = -1
            for t, tok in enumerate(seq):
                if tok == prev:
                    if tok != blank:
                        ends[-1] = t + 1
                else:
                    if tok != blank:
                        ids.append(tok)
                        starts.append(t)
                        ends.append(t + 1)
                prev = tok
            aligned = self._aligned_tokens(ids, starts, ends)
            aligned_lists.append(aligned)
            result = nemo_alignment.sentences_to_result(
                nemo_alignment.tokens_to_sentences(aligned))
            outputs.append(STTOutput(
                text=result.text, segments=self._result_to_segments(result),
                generation_token_count=len(ids), total_time=elapsed,
                generation_time=elapsed,
            ))
        return outputs, aligned_lists

    # -- single utterance with long-audio chunking ------------------------------

    def generate(self, audio,
                 generation_parameters: STTGenerateParameters | None = None) -> STTOutput:
        """One utterance (channels last are averaged to mono). Audio longer
        than ``chunk_duration`` (default 1200 s) is cut into chunks with a
        2 s overlap (a quarter chunk below 8 s), decoded in one batch and
        merged by aligning the chunks' shared tokens."""
        params = generation_parameters or STTGenerateParameters(max_tokens=8192)
        audio = np.asarray(audio, np.float32)
        if audio.ndim > 1:
            audio = audio.mean(axis=-1)
        sr = self.config.preprocess.sample_rate
        chunk_s = params.chunk_duration or 1200.0
        overlap_s = min(2.0, chunk_s / 4)
        chunk = int(chunk_s * sr)
        if len(audio) <= chunk:
            return self.generate_batch([audio], params)[0]
        step = max(1, chunk - int(overlap_s * sr))
        pieces = [audio[s : s + chunk] for s in range(0, len(audio), step)]
        outs, aligned_lists = self.generate_batch_aligned(pieces, params)
        all_tokens: list = []
        for idx, chunk_tokens in enumerate(aligned_lists):
            offset = idx * step / sr
            shifted = [
                nemo_alignment.AlignedToken(
                    id=t.id, text=t.text, start=t.start + offset, duration=t.duration)
                for t in chunk_tokens
            ]
            all_tokens = nemo_alignment.merge_token_sequences(all_tokens, shifted, overlap_s)
        result = nemo_alignment.sentences_to_result(
            nemo_alignment.tokens_to_sentences(all_tokens))
        return STTOutput(text=result.text,
                         segments=self._result_to_segments(result),
                         generation_token_count=len(all_tokens),
                         total_time=sum(o.total_time for o in outs),
                         generation_time=sum(o.generation_time for o in outs))

    def generate_stream(self, audio, generation_parameters=None):
        out = self.generate(audio, generation_parameters)
        yield {"type": "token", "text": out.text}
        yield {"type": "result", "output": out}
