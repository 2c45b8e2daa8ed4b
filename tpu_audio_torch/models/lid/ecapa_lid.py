"""ECAPA-TDNN language identification (VoxLingua107) on the PyTorch port.

Port of tpu_audio.models.lid.ecapa_lid: TDNN blocks (conv + ReLU + BN),
SE-Res2Net blocks, multi-layer feature aggregation, attentive statistics
pooling, BN + 1x1-conv embedding head, then the SpeechBrain classifier
(leaky ReLU + BN + DNN block + linear + log-softmax). The frontend is the
SpeechBrain mel: periodic Hamming, constant centre pad, HTK mel, power to
dB with ``top_db`` 80, sentence mean normalisation.

Everything after the waveform's upload runs on the params' device in
plain PyTorch ops (no kernel of the port: the JAX package reaches no Pallas
kernel here either), with the convolutions in full f32
(``nn.f32_convolutions``). ``predict_batch`` pads clips to the JAX
package's length buckets and runs the masked pipeline, one call a bucket.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from tpu_audio_torch.core import dsp, hub, loading, nn
from tpu_audio_torch.models.lid.wav2vec2_lid import LanguagePrediction, LIDOutput

__all__ = ["EcapaLID", "EcapaConfig", "ecapa_backbone_forward", "ecapa_mel", "sanitize",
           "init_random_params"]

N_FFT, HOP, SAMPLE_RATE, TOP_DB = 400, 160, 16000, 80.0


@dataclass
class EcapaConfig:
    input_size: int = 60
    channels: int = 1024
    embed_dim: int = 256
    kernel_sizes: tuple = (5, 3, 3, 3, 1)
    dilations: tuple = (1, 2, 3, 4, 1)
    attention_channels: int = 128
    res2net_scale: int = 8
    se_channels: int = 128
    global_context: bool = False
    # IndexTTS's speaker encoder pads its convs by reflection, not zeros
    reflect_padding: bool = False
    num_classes: int = 107
    classifier_hidden_dim: int = 512
    id2label: dict = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "EcapaConfig":
        keys = set(cls.__dataclass_fields__)
        kw = {k: v for k, v in d.items() if k in keys}
        for k in ("kernel_sizes", "dilations"):
            if k in kw:
                kw[k] = tuple(kw[k])
        return cls(**kw)


def _tdnn(p, x: torch.Tensor, kernel: int, dilation: int = 1,
          reflect: bool = False) -> torch.Tensor:
    """Conv (zero or reflect 'same' padding, dilation) + ReLU + BN on
    ``[B, T, C]``."""
    pad = (kernel - 1) * dilation // 2
    if reflect and pad:
        x = F.pad(x.transpose(1, 2), (pad, pad), mode="reflect").transpose(1, 2)
        pad = 0
    y = torch.relu(nn.conv1d(p["conv"], x, padding=pad, dilation=dilation))
    return nn.batch_norm(p["norm"], y)


def _se_res2net(p, x: torch.Tensor, cfg: EcapaConfig, kernel: int,
                dilation: int) -> torch.Tensor:
    residual = x
    out = _tdnn(p["tdnn1"], x, 1)  # kernel 1: the padding mode is moot
    chunks = out.chunk(cfg.res2net_scale, dim=-1)
    outs = [chunks[0]]
    for i in range(cfg.res2net_scale - 1):
        inp = chunks[i + 1] if i == 0 else chunks[i + 1] + outs[-1]
        outs.append(_tdnn(p["res2net_block"]["blocks"][str(i)], inp, kernel, dilation,
                          reflect=cfg.reflect_padding))
    out = _tdnn(p["tdnn2"], torch.cat(outs, dim=-1), 1)
    s = out.mean(dim=1, keepdim=True)
    s = torch.relu(nn.conv1d(p["se_block"]["conv1"], s))
    s = torch.sigmoid(nn.conv1d(p["se_block"]["conv2"], s))
    return out * s + residual


def ecapa_backbone_forward(p, x: torch.Tensor, cfg: EcapaConfig,
                           mask: torch.Tensor | None = None) -> torch.Tensor:
    """mel ``[B, T, n_mels]`` -> embeddings ``[B, embed_dim]``.

    ``mask [B, T]`` (bool) marks the valid frames of length-padded rows:
    the global-context statistics and the attentive-pooling softmax then
    leave the padded frames out, so a padded row's embedding matches its
    solo one up to the convolutions' edge effects (~30 frames)."""
    out = _tdnn(p["block0"], x, cfg.kernel_sizes[0], cfg.dilations[0],
                reflect=cfg.reflect_padding)
    feats = []
    for i in (1, 2, 3):
        out = _se_res2net(p[f"block{i}"], out, cfg, cfg.kernel_sizes[i], cfg.dilations[i])
        feats.append(out)
    out = _tdnn(p["mfa"], torch.cat(feats, dim=-1), cfg.kernel_sizes[4], cfg.dilations[4],
                reflect=cfg.reflect_padding)
    ap = p["asp"]
    if cfg.global_context:
        if mask is None:
            mean = out.mean(dim=1, keepdim=True)
            std = torch.sqrt(out.var(dim=1, keepdim=True, unbiased=False) + 1e-9)
        else:
            mf = mask[..., None].to(out.dtype)
            nf = mask.sum(dim=1).to(out.dtype).clamp(min=1.0)[:, None, None]
            mean = (out * mf).sum(dim=1, keepdim=True) / nf
            var = ((out - mean) ** 2 * mf).sum(dim=1, keepdim=True) / nf
            std = torch.sqrt(var + 1e-9)
        attn_in = torch.cat([out, mean.expand_as(out), std.expand_as(out)], dim=-1)
    else:
        attn_in = out
    a = torch.tanh(_tdnn(ap["tdnn"], attn_in, 1))
    logits = nn.conv1d(ap["conv"], a)
    if mask is not None:
        logits = logits.masked_fill(~mask[..., None], -1e9)
    a = torch.softmax(logits, dim=1)
    w_mean = (a * out).sum(dim=1)
    w_var = (a * out * out).sum(dim=1) - w_mean ** 2
    pooled = torch.cat([w_mean, torch.sqrt(w_var.clamp(min=1e-9))], dim=-1)
    pooled = nn.batch_norm(p["asp_bn"], pooled)
    return nn.conv1d(p["fc"], pooled[:, None])[:, 0]


def _power_mel(audio: torch.Tensor) -> torch.Tensor:
    """``[..., S]`` -> mel power ``[..., 1 + S // 160, 60]``: zero centre
    pad, periodic Hamming STFT, ``|X|^2 @ fb``."""
    lead = audio.shape[:-1]
    x = F.pad(audio.reshape(-1, audio.shape[-1]).to(torch.float32), (N_FFT // 2, N_FFT // 2))
    window = torch.from_numpy(dsp.hamming_window(N_FFT, periodic=True)).to(x.device)
    spec = torch.stft(x, N_FFT, hop_length=HOP, win_length=N_FFT, window=window, center=False,
                      return_complex=True).transpose(1, 2)
    fb = torch.from_numpy(dsp.mel_filters(SAMPLE_RATE, N_FFT, 60, norm=None, mel_scale="htk"))
    return (spec.abs() ** 2 @ fb.to(x.device)).reshape(*lead, -1, 60)


def ecapa_mel(audio) -> torch.Tensor:
    """SpeechBrain-compatible mel ``[1, T, 60]`` in dB (``top_db`` 80 over
    the clip) of a 1D array (on the CPU) or tensor (on its device)."""
    if not isinstance(audio, torch.Tensor):
        audio = torch.from_numpy(np.ascontiguousarray(audio, np.float32))
    return dsp.power_to_db(_power_mel(audio.reshape(-1)), top_db=TOP_DB)[None]


def sanitize(weights: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """SpeechBrain checkpoint remaps (``blocks.N`` -> ``blockN``, the doubled
    ``conv.conv`` / ``norm.norm`` names, ``se_block``, ``asp_bn`` and ``fc``
    wrappers), ``num_batches_tracked`` dropped, and the MLX conv layout
    ``[O, K, I]`` -> ``[O, I, K]``."""
    out = {}
    for k, v in weights.items():
        if "num_batches_tracked" in k:
            continue
        for i in range(4):
            k = k.replace(f"embedding_model.blocks.{i}.", f"embedding_model.block{i}.")
        k = k.replace(".conv.conv.", ".conv.").replace(".norm.norm.", ".norm.")
        k = k.replace(".se_block.conv1.conv.", ".se_block.conv1.")
        k = k.replace(".se_block.conv2.conv.", ".se_block.conv2.")
        k = k.replace(".asp_bn.norm.", ".asp_bn.").replace(".fc.conv.", ".fc.")
        if k.endswith(".weight") and v.ndim == 3 and v.shape[1] <= 5 and v.shape[1] != v.shape[2]:
            v = v.permute(0, 2, 1).contiguous()
        out[k] = v
    return out


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.01 * x)


def _classify(c, emb: torch.Tensor) -> torch.Tensor:
    """The SpeechBrain classifier: embeddings -> logits."""
    h = nn.batch_norm(c["norm"], _leaky(emb))
    h = _leaky(nn.linear(c["DNN"]["block_0"]["linear"]["w"], h))
    h = nn.batch_norm(c["DNN"]["block_0"]["norm"], h)
    return nn.linear(c["out"]["w"], h)


def init_random_params(cfg: EcapaConfig, seed: int = 0, device=None) -> dict:
    """Random f32 params in the sanitized checkpoint's layout at ``cfg``'s
    widths, drawn on ``device`` from a ``torch.Generator``: conv and linear
    weights N(0, 2/fan_in) (ReLU gain), biases N(0, 0.01), BatchNorm
    weights 1 + N(0, 0.1), biases and running means N(0, 0.1), running
    variances in [0.5, 1.5); block 0's and the pooled statistics' running
    variances are 100x that, as block 0's input is the mean-normalised dB
    mel and the pooled means and deviations run to tens (so that the
    logits stay a few units wide and the probabilities off saturation)."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    def conv(o, i, k):
        return {"weight": randn(o, i, k, std=(2.0 / (i * k)) ** 0.5), "bias": randn(o, std=0.01)}

    def bn(ch, var_scale=1.0):
        return {"weight": 1.0 + randn(ch, std=0.1), "bias": randn(ch, std=0.1),
                "running_mean": randn(ch, std=0.1),
                "running_var": (0.5 + torch.rand((ch,), generator=gen, device=device))
                * var_scale}

    def tdnn(o, i, k, var_scale=1.0):
        return {"conv": conv(o, i, k), "norm": bn(o, var_scale)}

    ch, se, scale = cfg.channels, cfg.se_channels, cfg.res2net_scale
    em = {"block0": tdnn(ch, cfg.input_size, cfg.kernel_sizes[0], var_scale=100.0)}
    for b in (1, 2, 3):
        em[f"block{b}"] = {
            "tdnn1": tdnn(ch, ch, 1),
            "res2net_block": {"blocks": {str(i): tdnn(ch // scale, ch // scale,
                                                      cfg.kernel_sizes[b])
                                         for i in range(scale - 1)}},
            "tdnn2": tdnn(ch, ch, 1),
            "se_block": {"conv1": conv(se, ch, 1), "conv2": conv(ch, se, 1)}}
    attn_in = ch * 9 if cfg.global_context else ch * 3
    em.update(mfa=tdnn(ch * 3, ch * 3, cfg.kernel_sizes[4]),
              asp={"tdnn": tdnn(cfg.attention_channels, attn_in, 1),
                   "conv": conv(ch * 3, cfg.attention_channels, 1)},
              asp_bn=bn(ch * 6, var_scale=100.0), fc=conv(cfg.embed_dim, ch * 6, 1))
    hid = cfg.classifier_hidden_dim

    def lin(o, i):
        return {"weight": randn(o, i, std=(2.0 / i) ** 0.5), "bias": randn(o, std=0.01)}

    return {"embedding_model": em,
            "classifier": {"norm": bn(cfg.embed_dim),
                           "DNN": {"block_0": {"linear": {"w": lin(hid, cfg.embed_dim)},
                                               "norm": bn(hid)}},
                           "out": {"w": lin(cfg.num_classes, hid)}}}


class EcapaLID:
    """ECAPA-TDNN language ID on its params' device: ``predict`` (one clip),
    ``predict_device`` (probabilities left on the device) and
    ``predict_batch`` (length-bucketed masked batches)."""

    def __init__(self, config: EcapaConfig, params, dtype=torch.float32):
        self.config = config
        self.params = params
        self.dtype = dtype
        self.device = params["embedding_model"]["block0"]["conv"]["weight"].device
        self.id2label = {int(k): str(v).split(":")[0].strip()
                         for k, v in (config.id2label or {}).items()}

    @classmethod
    def from_pretrained(cls, repo_or_path: str, dtype=torch.float32,
                        device="cuda") -> "EcapaLID":
        """Load a local checkpoint directory (SpeechBrain or MLX layout)
        onto ``device``."""
        model_dir = hub.resolve_model_dir(repo_or_path)
        config = EcapaConfig.from_dict(hub.load_config(model_dir))
        params = loading.load_params(model_dir, sanitize=sanitize, dtype=dtype)
        return cls(config, loading.to_device(params, device), dtype)

    def _head(self, mel: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """Normalised mel ``[B, T, 60]`` -> logits ``[B, num_classes]``."""
        emb = ecapa_backbone_forward(self.params["embedding_model"], mel.to(self.dtype),
                                     self.config, mask=mask)
        return _classify(self.params["classifier"], emb)

    @torch.inference_mode()
    def predict_device(self, waveform) -> torch.Tensor:
        """waveform -> language probabilities ``[num_classes]`` f32, left on
        the device."""
        audio = torch.from_numpy(np.ascontiguousarray(
            np.asarray(waveform, np.float32).reshape(-1))).to(self.device)
        with nn.f32_convolutions():
            mel = ecapa_mel(audio)
            mel = mel - mel.mean(dim=1, keepdim=True)  # sentence mean norm
            logp = torch.log_softmax(self._head(mel), dim=-1)
        return torch.exp(logp[0].to(torch.float32))

    def predict(self, waveform, top_k: int = 5) -> LIDOutput:
        return self._to_output(self.predict_device(waveform).cpu().numpy(), top_k)

    def _to_output(self, probs: np.ndarray, top_k: int) -> LIDOutput:
        order = np.argsort(-probs)[: min(top_k, len(probs))]
        top = [LanguagePrediction(self.id2label.get(int(i), f"unknown_{i}"), float(probs[i]))
               for i in order]
        best = top[0] if top else LanguagePrediction("unknown", 0.0)
        return LIDOutput(best.language, best.confidence, top)

    # sample-count buckets: a clip pads up to <= 2x its length; past the
    # largest it runs alone through predict
    _LEN_BUCKETS = tuple(16000 * s for s in (1, 2, 4, 8, 16, 30))

    @torch.inference_mode()
    def _predict_bucket(self, audio: torch.Tensor, n_frames: torch.Tensor) -> torch.Tensor:
        """``audio [B, S]`` (rows zero-padded to the bucket), ``n_frames
        [B]`` (each row's true ``1 + n // 160``) -> probabilities ``[B,
        num_classes]`` f32: per-row masked dB clamp and mean norm, masked
        backbone."""
        with nn.f32_convolutions():
            mel = _power_mel(audio)  # [B, T, 60]
            mask = torch.arange(mel.shape[1], device=mel.device)[None] < n_frames[:, None]
            mf = mask[..., None].to(torch.float32)
            n = n_frames.to(torch.float32).clamp(min=1.0)[:, None, None]
            # the clamp to max - top_db per row: the solo path's global max
            # must not leak across rows
            db = 10.0 * torch.log10(mel.clamp(min=1e-10))
            row_max = db.masked_fill(~mask[..., None], -torch.inf).amax(dim=(1, 2), keepdim=True)
            db = torch.maximum(db, row_max - TOP_DB)
            mean = (db * mf).sum(dim=1, keepdim=True) / n
            logits = self._head((db - mean) * mf, mask=mask)
            return torch.exp(torch.log_softmax(logits.to(torch.float32), dim=-1))

    def predict_batch(self, waveforms: list, top_k: int = 5) -> list[LIDOutput]:
        """Classify several clips, one device call a length bucket (rows
        padded to a power-of-two count); a padded row's probabilities match
        its solo ``predict`` up to the convolutions' edge effects. The
        server's micro-batcher calls this."""
        clips = [np.asarray(w, np.float32).reshape(-1) for w in waveforms]
        out: list[LIDOutput | None] = [None] * len(clips)
        groups: dict[int, list[int]] = {}
        for i, c in enumerate(clips):
            bucket = next((b for b in self._LEN_BUCKETS if len(c) <= b), None)
            if bucket is None:
                out[i] = self.predict(c, top_k)
            else:
                groups.setdefault(bucket, []).append(i)
        for bucket, idxs in groups.items():
            rows = 1 << (len(idxs) - 1).bit_length()
            audio = np.zeros((rows, bucket), np.float32)
            n_frames = np.ones((rows,), np.int64)
            for row, i in enumerate(idxs):
                audio[row, : len(clips[i])] = clips[i]
                n_frames[row] = 1 + len(clips[i]) // HOP
            probs = self._predict_bucket(torch.from_numpy(audio).to(self.device),
                                         torch.from_numpy(n_frames).to(self.device))
            probs = probs.cpu().numpy()
            for row, i in enumerate(idxs):
                out[i] = self._to_output(probs[row], top_k)
        return out  # type: ignore[return-value]
