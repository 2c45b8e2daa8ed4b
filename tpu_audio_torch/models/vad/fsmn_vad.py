"""FSMN VAD (FunASR ``fsmn-vad``) on the PyTorch port.

Port of tpu_audio.models.vad.fsmn_vad: Kaldi fbank features (int16-scaled
waveform, per-frame DC removal, 0.97 pre-emphasis, NumPy's symmetric
Hamming window, an rfft at the next power of two, the Kaldi-mel triangular
filterbank from 20 Hz, a log floored at 1e-8) -> LFR stacking (m = 5, n =
1, frame 0 repeated on the left) -> CMVN ``(x + shift) * scale`` -> the
FSMN encoder (a linear stack with depthwise causal "memory" convolutions
and residuals) -> an f32 softmax over the acoustic states, of which
``sil_pdf_ids`` are silence.

The fbank, LFR, CMVN and encoder run on the params' device in plain
PyTorch ops (the JAX package reaches no Pallas kernel here either), the
memory convolutions in full f32 (``nn.f32_convolutions``). The endpoint
decision (windowed hysteresis, decibel and SNR gating, FunASR's segment
state machine) is sequential host code over the score matrix, in NumPy,
as in the JAX package.
"""

from __future__ import annotations

import functools
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from tpu_audio_torch.core import hub, loading, nn
from tpu_audio_torch.core.audio_io import resample_audio

__all__ = ["FSMNVAD", "FSMNVADConfig", "FSMNEncoderConfig", "FSMNVADPostprocess",
           "kaldi_mel_filterbank", "apply_lfr", "parse_kaldi_cmvn", "encoder_forward",
           "sanitize", "init_random_params"]


@dataclass
class FSMNEncoderConfig:
    input_dim: int = 400
    input_affine_dim: int = 140
    fsmn_layers: int = 4
    linear_dim: int = 250
    proj_dim: int = 128
    lorder: int = 20
    rorder: int = 0
    lstride: int = 1
    rstride: int = 0
    output_affine_dim: int = 140
    output_dim: int = 248


@dataclass
class FSMNVADConfig:
    encoder: FSMNEncoderConfig = field(default_factory=FSMNEncoderConfig)
    sample_rate: int = 16000
    n_mels: int = 80
    frame_length: int = 25  # ms
    frame_shift: int = 10  # ms
    lfr_m: int = 5
    lfr_n: int = 1
    max_end_silence_time: int = 800
    max_start_silence_time: int = 3000
    window_size_ms: int = 200
    sil_to_speech_time_thres: int = 150
    speech_to_sil_time_thres: int = 150
    speech_noise_thres: float = 0.6
    sil_pdf_ids: tuple = (0,)
    frame_in_ms: int = 10

    @classmethod
    def from_dict(cls, d: dict) -> "FSMNVADConfig":
        enc_keys = set(FSMNEncoderConfig.__dataclass_fields__)
        enc = FSMNEncoderConfig(**{k: v for k, v in d.get("encoder", {}).items()
                                   if k in enc_keys})
        keys = set(cls.__dataclass_fields__) - {"encoder"}
        kw = {k: v for k, v in d.items() if k in keys}
        if "sil_pdf_ids" in kw:
            kw["sil_pdf_ids"] = tuple(kw["sil_pdf_ids"])
        return cls(encoder=enc, **kw)


# -- Kaldi frontend ----------------------------------------------------------------


def _kaldi_mel(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


@functools.lru_cache(maxsize=8)
def kaldi_mel_filterbank(n_mels: int, n_fft: int, sample_rate: int,
                         low_freq: float = 20.0) -> np.ndarray:
    """``[n_fft//2 + 1, n_mels]`` triangular filters on the Kaldi mel scale;
    the Nyquist row stays zero."""
    n_bins = n_fft // 2
    mel_low, mel_high = _kaldi_mel(low_freq), _kaldi_mel(0.5 * sample_rate)
    mel_delta = (mel_high - mel_low) / (n_mels + 1)
    mel = _kaldi_mel(sample_rate / n_fft * np.arange(n_bins))[:, None]
    left = mel_low + np.arange(n_mels)[None, :] * mel_delta
    center, right = left + mel_delta, left + 2 * mel_delta
    up = (mel - left) / (center - left)
    down = (right - mel) / (right - center)
    bank = np.maximum(0.0, np.minimum(up, down)).astype(np.float32)
    return np.concatenate([bank, np.zeros((1, n_mels), np.float32)], axis=0)


def _kaldi_fbank(audio: torch.Tensor, win_len: int, win_inc: int, n_mels: int,
                 sample_rate: int) -> torch.Tensor:
    """Waveform ``[S]`` (int16-scaled floats) -> log-fbank ``[T, n_mels]`` on
    its device."""
    frames = audio.unfold(0, win_len, win_inc)  # [1 + (S - win_len) // win_inc, win_len]
    frames = frames - frames.mean(dim=1, keepdim=True)
    frames = torch.cat([frames[:, :1], frames[:, 1:] - 0.97 * frames[:, :-1]], dim=1)
    n_fft = 1 << max(0, win_len - 1).bit_length()
    window = torch.from_numpy(np.hamming(win_len).astype(np.float32)).to(audio.device)
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=1).abs() ** 2
    bank = torch.from_numpy(kaldi_mel_filterbank(n_mels, n_fft, sample_rate)).to(audio.device)
    return torch.log(torch.clamp(spec @ bank, min=1e-8))


def apply_lfr(features: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Low-frame-rate stacking ``[T, D]`` -> ``[ceil((T + (m-1)//2) / n), D*m]``:
    the left pad repeats frame 0, the tail clamps to the last frame."""
    t, d = features.shape
    if t == 0:
        return features.new_zeros((0, d * m))
    left = (m - 1) // 2
    t_out = (t + left + n - 1) // n
    src = (torch.arange(t_out, device=features.device)[:, None] * n
           + torch.arange(m, device=features.device)[None, :] - left).clamp(0, t - 1)
    return features[src].reshape(t_out, d * m)


def parse_kaldi_cmvn(text: str):
    """The ``<AddShift>`` / ``<Rescale>`` vectors of a Kaldi ``am.mvn``."""

    def block(marker):
        m = re.search(re.escape(marker) + r"[^\[]*\[([^\]]*)\]", text)
        if not m:
            return None
        return np.array([float(v) for v in m.group(1).split()], np.float32)

    shift, scale = block("<AddShift>"), block("<Rescale>")
    if shift is None or scale is None:
        raise ValueError("could not parse Kaldi CMVN data")
    return shift, scale


# -- encoder -----------------------------------------------------------------------


def encoder_forward(params, x: torch.Tensor, cfg: FSMNEncoderConfig) -> torch.Tensor:
    """Features ``[B, T, input_dim]`` -> f32 softmax scores ``[B, T,
    output_dim]``."""
    h = nn.linear(params["in_linear1"], x)
    h = torch.relu(nn.linear(params["in_linear2"], h))
    pad = (cfg.lorder - 1) * cfg.lstride
    for i in range(cfg.fsmn_layers):
        p = params["fsmn"][str(i)]
        proj = nn.linear(p["linear"], h)
        padded = torch.nn.functional.pad(proj, (0, 0, pad, 0))
        mem = proj + nn.conv1d(p["fsmn_block"]["conv_left"], padded, groups=proj.shape[-1])
        h = torch.relu(nn.linear(p["affine"], mem))
    h = nn.linear(params["out_linear2"], nn.linear(params["out_linear1"], h))
    return torch.softmax(h.to(torch.float32), dim=-1)


def sanitize(weights: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The ``encoder.`` prefix stripped; an MLX depthwise conv ``[O, K, 1]``
    -> ``[O, 1, K]``."""
    out = {}
    for k, v in weights.items():
        if k.startswith("encoder."):
            k = k[len("encoder."):]
        if "conv_left.weight" in k and v.ndim == 3 and v.shape[-1] == 1:
            v = v.permute(0, 2, 1).contiguous()
        out[k] = v
    return out


def init_random_params(cfg: FSMNEncoderConfig, seed: int = 0, device=None) -> dict:
    """Random f32 params in the sanitized checkpoint's layout at ``cfg``'s
    widths, drawn on ``device`` from a ``torch.Generator``: linear weights
    N(0, 1/fan_in) (the in/affine layers before a ReLU x 2), biases
    N(0, 0.1), memory taps N(0, 1/lorder)."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    def lin(o, i, bias=True, gain=1.0):
        p = {"weight": randn(o, i, std=(gain / i) ** 0.5)}
        if bias:
            p["bias"] = randn(o, std=0.1)
        return p

    c = cfg
    return {
        "in_linear1": lin(c.input_affine_dim, c.input_dim),
        "in_linear2": lin(c.linear_dim, c.input_affine_dim, gain=2.0),
        "fsmn": {str(i): {"linear": lin(c.proj_dim, c.linear_dim, bias=False),
                          "fsmn_block": {"conv_left": {
                              "weight": randn(c.proj_dim, 1, c.lorder, std=c.lorder ** -0.5)}},
                          "affine": lin(c.linear_dim, c.proj_dim, gain=2.0)}
                 for i in range(c.fsmn_layers)},
        "out_linear1": lin(c.output_affine_dim, c.linear_dim),
        "out_linear2": lin(c.output_dim, c.output_affine_dim),
    }


# -- endpoint state machine (host side) ---------------------------------------------

_SIL, _SPEECH = 0, 1
_STATE_START_NOT_DETECTED, _STATE_IN_SPEECH, _STATE_END_DETECTED = 0, 1, 2
_S2S, _S2SIL, _SIL2SIL, _SIL2S = 0, 1, 2, 3


class _WindowDetector:
    """Sliding majority-vote hysteresis."""

    def __init__(self, window_ms, sil_to_speech_ms, speech_to_sil_ms, frame_ms):
        self.win_size = max(window_ms // frame_ms, 1)
        self.sil_to_speech = sil_to_speech_ms // frame_ms
        self.speech_to_sil = speech_to_sil_ms // frame_ms
        self.reset()

    def reset(self):
        self.pos = 0
        self.win_sum = 0
        self.win = [0] * self.win_size
        self.prev = _SIL

    def step(self, frame_is_speech: int) -> int:
        self.win_sum += frame_is_speech - self.win[self.pos]
        self.win[self.pos] = frame_is_speech
        self.pos = (self.pos + 1) % self.win_size
        if self.prev == _SIL and self.win_sum >= self.sil_to_speech:
            self.prev = _SPEECH
            return _SIL2S
        if self.prev == _SPEECH and self.win_sum <= self.speech_to_sil:
            self.prev = _SIL
            return _S2SIL
        return _SIL2SIL if self.prev == _SIL else _S2S


class _Segment:
    __slots__ = ("start_ms", "end_ms", "has_start", "has_end")

    def __init__(self):
        self.start_ms = self.end_ms = 0
        self.has_start = self.has_end = False


class FSMNVADPostprocess:
    """FunASR's endpoint decision over the score and decibel streams.
    Stateful: ``process`` may be called with successive blocks; each segment
    is emitted once, when it is decided."""

    def __init__(self, cfg: FSMNVADConfig):
        self.cfg = cfg
        self.detector = _WindowDetector(
            cfg.window_size_ms, cfg.sil_to_speech_time_thres,
            cfg.speech_to_sil_time_thres, cfg.frame_in_ms)
        self.max_end_sil_ms = cfg.max_end_silence_time - cfg.speech_to_sil_time_thres
        self.frame_count = 0
        self.next_frame = 0
        self.state = _STATE_START_NOT_DETECTED
        self.latest_speech_frame = 0
        self.latest_silence_frame = -1
        self.continuous_silence = 0
        self.confirmed_start = -1
        self.confirmed_end = -1
        self.n_ends_detected = 0
        self.noise_avg_db = -100.0
        self.data_buf_start_frame = 0
        self.last_drop_frames = 0
        self.segments: list[_Segment] = []
        self.emitted = 0
        self.scores: list[np.ndarray] = []
        self.decibel: list[float] = []
        self._wf_residual = np.zeros(0, np.float32)

    # latency between a true start and its detection
    def _start_latency(self) -> int:
        return self.detector.win_size + self.cfg.window_size_ms // self.cfg.frame_in_ms

    def _append_segment_frame(self, start_frame, is_start, is_end):
        self.data_buf_start_frame = max(self.data_buf_start_frame, start_frame)
        if not self.segments or is_start:
            seg = _Segment()
            seg.start_ms = start_frame * self.cfg.frame_in_ms
            seg.end_ms = seg.start_ms
            self.segments.append(seg)
        cur = self.segments[-1]
        self.data_buf_start_frame += 1
        cur.end_ms = (start_frame + 1) * self.cfg.frame_in_ms
        cur.has_start = cur.has_start or is_start
        cur.has_end = cur.has_end or is_end

    def _on_voice_detected(self, frame):
        self.latest_speech_frame = frame
        self._append_segment_frame(frame, False, False)

    def _on_voice_start(self, frame, fake=False):
        if self.confirmed_start == -1:
            self.confirmed_start = frame
        if not fake and self.state == _STATE_START_NOT_DETECTED:
            self._append_segment_frame(self.confirmed_start, True, False)

    def _on_voice_end(self, frame, fake=False):
        for f in range(self.latest_speech_frame + 1, frame):
            self._on_voice_detected(f)
        if self.confirmed_end == -1:
            self.confirmed_end = frame
        if not fake:
            self._append_segment_frame(self.confirmed_end, False, True)
        self.n_ends_detected += 1

    def _reset_detection(self):
        self.continuous_silence = 0
        self.latest_speech_frame = 0
        self.latest_silence_frame = -1
        self.confirmed_start = -1
        self.confirmed_end = -1
        self.state = _STATE_START_NOT_DETECTED
        self.detector.reset()
        if self.segments and self.segments[-1].has_end:
            drop = self.segments[-1].end_ms // self.cfg.frame_in_ms
            real_drop = drop - self.last_drop_frames
            self.last_drop_frames = drop
            del self.decibel[:real_drop]
            del self.scores[:real_drop]

    def _frame_state(self, index: int) -> int:
        """Speech or silence for one frame: the silence posterior's
        threshold gated by a decibel floor; silence frames update the
        rolling noise-floor estimate."""
        if index < 0 or index >= len(self.decibel) or index >= len(self.scores):
            return _SIL
        db = self.decibel[index]
        if db < -100.0:
            return _SIL
        row = self.scores[index]
        sil_score = float(sum(row[i] for i in self.cfg.sil_pdf_ids if i < len(row)))
        sil_score = min(max(sil_score, 1e-7), 1.0 - 1e-7)
        speech_prob = 1.0 - sil_score
        if speech_prob >= sil_score + self.cfg.speech_noise_thres:
            snr = db - self.noise_avg_db
            if snr >= -100.0:
                return _SPEECH
            return _SIL
        if self.noise_avg_db < -99.9:
            self.noise_avg_db = db
        else:
            self.noise_avg_db = (db + self.noise_avg_db * 99.0) / 100.0
        return _SIL

    def _detect_one_frame(self, frame_is_speech: int, frame: int, is_final: bool):
        change = self.detector.step(frame_is_speech)
        ms = self.cfg.frame_in_ms
        max_single = 60000 // ms

        def end_here(f):
            self._on_voice_end(f)
            self.state = _STATE_END_DETECTED

        if change == _SIL2S:
            self.continuous_silence = 0
            if self.state == _STATE_START_NOT_DETECTED:
                start = max(self.data_buf_start_frame, frame - self._start_latency())
                self._on_voice_start(start)
                self.state = _STATE_IN_SPEECH
                for f in range(start + 1, frame + 1):
                    self._on_voice_detected(f)
            elif self.state == _STATE_IN_SPEECH:
                for f in range(self.latest_speech_frame + 1, frame):
                    self._on_voice_detected(f)
                if frame - self.confirmed_start + 1 > max_single:
                    end_here(frame)
                elif not is_final:
                    self._on_voice_detected(frame)
                elif is_final:
                    end_here(frame)
        elif change in (_S2SIL, _S2S):
            self.continuous_silence = 0
            if self.state == _STATE_IN_SPEECH:
                if frame - self.confirmed_start + 1 > max_single:
                    end_here(frame)
                elif not is_final:
                    self._on_voice_detected(frame)
                else:
                    end_here(frame)
        elif change == _SIL2SIL:
            self.continuous_silence += 1
            if self.state == _STATE_START_NOT_DETECTED:
                if is_final and self.n_ends_detected == 0:
                    self._on_voice_start(0, fake=True)
                    self._on_voice_end(0, fake=True)
                    self.state = _STATE_END_DETECTED
                elif frame >= self._start_latency():
                    self.latest_silence_frame = frame - self._start_latency()
                    if self.state == _STATE_START_NOT_DETECTED:
                        self.data_buf_start_frame = max(self.data_buf_start_frame,
                                                        self.latest_silence_frame)
            elif self.state == _STATE_IN_SPEECH:
                if self.continuous_silence * ms >= self.max_end_sil_ms:
                    lookback = max(0, self.max_end_sil_ms // ms
                                   - self.cfg.window_size_ms // ms // 2 - 1)
                    end_here(frame - lookback)
                elif frame - self.confirmed_start + 1 > max_single:
                    end_here(frame)
                elif (self.continuous_silence <= self.cfg.window_size_ms // ms // 2
                      and not is_final):
                    self._on_voice_detected(frame)
                elif is_final:
                    end_here(frame)

        if self.state == _STATE_END_DETECTED:
            self._reset_detection()

    def process(self, scores: np.ndarray, waveform: np.ndarray,
                is_final: bool = True) -> list[list[int]]:
        """Feed a block of ``[T, n_states]`` scores and its waveform; returns
        the newly decided ``[start_ms, end_ms]`` segments."""
        # decibels a 25 ms frame at a 10 ms shift
        cfg = self.cfg
        flen = cfg.frame_length * cfg.sample_rate // 1000
        shift = cfg.frame_in_ms * cfg.sample_rate // 1000
        wf = np.concatenate([self._wf_residual, np.asarray(waveform, np.float32)])
        if len(wf) >= flen:
            n = (len(wf) - flen) // shift + 1
            idx = np.arange(n)[:, None] * shift + np.arange(flen)[None, :]
            energy = np.sum(wf[idx] ** 2, axis=1)
            self.decibel.extend((10.0 * np.log10(energy + 1e-6)).tolist())
            self._wf_residual = wf[n * shift:]
        else:
            self._wf_residual = wf
        self.frame_count += len(scores)
        self.scores.extend(np.asarray(scores, np.float32))

        # decide frames in order, each once its decibel frame exists (score
        # frames can outpace decibel frames at block boundaries); the final
        # block flushes everything
        while self.next_frame < self.frame_count:
            avail = self.last_drop_frames + min(len(self.scores), len(self.decibel))
            if not is_final and self.next_frame >= avail:
                break
            st = self._frame_state(self.next_frame - self.last_drop_frames)
            self._detect_one_frame(st, self.next_frame,
                                   is_final and self.next_frame == self.frame_count - 1)
            self.next_frame += 1

        out = []
        while self.emitted < len(self.segments):
            seg = self.segments[self.emitted]
            if not seg.has_end and not is_final:
                break  # still open: held until it closes (streaming)
            out.append([seg.start_ms, seg.end_ms])
            self.emitted += 1
        return out


# -- model -------------------------------------------------------------------------


class FSMNVAD:
    """FSMN VAD on its params' device: ``extract_features``, ``scores`` and
    ``detect``."""

    def __init__(self, config: FSMNVADConfig, params, cmvn: tuple | None = None,
                 dtype=torch.float32):
        self.config = config
        self.params = params
        self.cmvn = cmvn
        self.dtype = dtype
        self.sample_rate = config.sample_rate
        self.device = params["in_linear1"]["weight"].device

    @classmethod
    def from_pretrained(cls, repo_or_path: str, dtype=torch.float32,
                        device="cuda") -> "FSMNVAD":
        """Load a local checkpoint directory onto ``device``, with its CMVN
        from ``cmvn.json`` (``shift``, ``scale``) or a Kaldi ``am.mvn``."""
        model_dir = Path(hub.resolve_model_dir(repo_or_path))
        config = FSMNVADConfig.from_dict(hub.load_config(model_dir))
        params = loading.load_params(model_dir, sanitize=sanitize, dtype=dtype)
        cmvn = None
        if (model_dir / "cmvn.json").exists():
            d = json.loads((model_dir / "cmvn.json").read_text())
            cmvn = (np.asarray(d["shift"], np.float32), np.asarray(d["scale"], np.float32))
        elif (model_dir / "am.mvn").exists():
            cmvn = parse_kaldi_cmvn((model_dir / "am.mvn").read_text())
        return cls(config, loading.to_device(params, device), cmvn, dtype)

    def _waveform(self, waveform, sample_rate: int | None) -> np.ndarray:
        wf = np.asarray(waveform, np.float32).reshape(-1)
        src = sample_rate or self.config.sample_rate
        if src != self.config.sample_rate:
            wf = resample_audio(wf, src, self.config.sample_rate)
        return wf

    def _features(self, wf: np.ndarray) -> torch.Tensor:
        """16 kHz waveform -> CMVN'd LFR fbank ``[T, input_dim]`` f32 on the
        device."""
        cfg = self.config
        win_len = cfg.sample_rate * cfg.frame_length // 1000
        win_inc = cfg.sample_rate * cfg.frame_shift // 1000
        if len(wf) < win_len:
            return torch.zeros((0, cfg.n_mels * cfg.lfr_m), device=self.device)
        audio = torch.from_numpy(np.ascontiguousarray(wf * 32768.0)).to(self.device)
        feats = apply_lfr(_kaldi_fbank(audio, win_len, win_inc, cfg.n_mels, cfg.sample_rate),
                          cfg.lfr_m, cfg.lfr_n)
        if self.cmvn is not None:
            shift, scale = self.cmvn
            if shift.shape[0] == feats.shape[1]:
                feats = ((feats + torch.from_numpy(shift).to(self.device))
                         * torch.from_numpy(scale).to(self.device))
        return feats

    @torch.inference_mode()
    def extract_features(self, waveform, sample_rate: int | None = None) -> np.ndarray:
        """waveform -> CMVN'd LFR fbank ``[T, input_dim]``."""
        return self._features(self._waveform(waveform, sample_rate)).cpu().numpy()

    @torch.inference_mode()
    def scores(self, waveform, sample_rate: int | None = None) -> np.ndarray:
        """waveform -> softmax scores ``[T, output_dim]`` (one host read)."""
        feats = self._features(self._waveform(waveform, sample_rate))
        if feats.shape[0] == 0:
            return np.zeros((0, self.config.encoder.output_dim), np.float32)
        with nn.f32_convolutions():
            out = encoder_forward(self.params, feats.to(self.dtype)[None], self.config.encoder)
        return out[0].cpu().numpy()

    def detect(self, waveform, sample_rate: int | None = None) -> list[list[int]]:
        """waveform -> ``[[start_ms, end_ms], ...]``."""
        wf = self._waveform(waveform, sample_rate)
        return FSMNVADPostprocess(self.config).process(self.scores(wf), wf, is_final=True)
