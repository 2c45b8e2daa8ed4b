"""Wav2Vec2 / MMS on PyTorch (port of tpu_audio.models.stt.wav2vec2): a
raw-waveform conv feature extractor and a transformer encoder, with a CTC
head (STT, :class:`Wav2Vec2CTC`) or a sequence-classification head (LID,
``models.lid.wav2vec2_lid.Wav2Vec2LID``).

- Frontend: 7 strided 1D convolutions (no padding) with erf-GELU; in
  ``"group"`` mode layer 0 alone has a group norm with one group a channel
  (statistics over time), in ``"layer"`` mode every layer has a LayerNorm
  over channels. Then a LayerNorm and the feature projection.
- Positions: a grouped conv (kernel 128, padding 64, 16 groups) whose
  weight norm is folded at load; an even kernel drops the last frame.
- Encoder: post-LN layers (the LayerNorm before the first layer), or
  stable pre-LN layers (the LayerNorm after the last); MMS adapter layers
  (LayerNorm, linear, ReLU, linear, residual) after a layer where the
  checkpoint has them. Attention takes no mask: one utterance a call.

No kernel of the port runs on this path. Convolutions run in full f32
(``nn.f32_convolutions``), so an f32 model on the card is held to the CPU.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from tpu_audio_torch.core import hub, loading, nn
from tpu_audio_torch.core.generation import STTGenerateParameters, STTOutput, STTSegment

__all__ = ["Wav2Vec2CTC", "Wav2Vec2Config", "trunk_forward", "sanitize",
           "normalize", "init_random_params"]


@dataclass
class Wav2Vec2Config:
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    conv_dim: tuple = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: tuple = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = True
    feat_extract_norm: str = "layer"  # "group" | "layer"
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    do_stable_layer_norm: bool = True
    layer_norm_eps: float = 1e-5
    vocab_size: int = 32
    pad_token_id: int = 0
    adapter_attn_dim: int | None = None
    hidden_act: str = "gelu"
    # LID head
    classifier_proj_size: int = 256
    num_labels: int | None = None
    id2label: dict | None = None

    @classmethod
    def from_dict(cls, d: dict) -> "Wav2Vec2Config":
        keys = set(cls.__dataclass_fields__)
        kw = {k: v for k, v in d.items() if k in keys}
        for k in ("conv_dim", "conv_kernel", "conv_stride"):
            if k in kw:
                kw[k] = tuple(kw[k])
        return cls(**kw)


def _feature_extractor(p: dict, x: torch.Tensor, cfg: Wav2Vec2Config) -> torch.Tensor:
    """waveform ``[B, T]`` -> features ``[B, T', conv_dim[-1]]``."""
    h = x[..., None]
    for i, (dim, k, s) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride)):
        lp = p["conv_layers"][str(i)]
        h = nn.conv1d(lp["conv"], h, stride=s)
        if cfg.feat_extract_norm == "group" and i == 0:
            h = nn.group_norm(lp["layer_norm"], h, num_groups=dim)
        elif cfg.feat_extract_norm == "layer":
            h = nn.layer_norm(lp["layer_norm"], h, cfg.layer_norm_eps)
        h = nn.gelu(h)
    return h


def _pos_conv_embed(p: dict, x: torch.Tensor, cfg: Wav2Vec2Config) -> torch.Tensor:
    k = cfg.num_conv_pos_embeddings
    h = nn.conv1d(p["conv"], x, padding=k // 2, groups=cfg.num_conv_pos_embedding_groups)
    if k % 2 == 0:
        h = h[:, :-1]
    return nn.gelu(h)


def _attention(p: dict, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    q, k, v = (nn.linear(p[n], x).reshape(b, t, n_heads, d // n_heads).transpose(1, 2)
               for n in ("q_proj", "k_proj", "v_proj"))
    o = nn.sdpa(q, k, v)
    return nn.linear(p["out_proj"], o.transpose(1, 2).reshape(b, t, d))


def _feed_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    return nn.linear(p["output_dense"], nn.gelu(nn.linear(p["intermediate_dense"], x)))


def _encoder(p: dict, x: torch.Tensor, cfg: Wav2Vec2Config) -> torch.Tensor:
    eps = cfg.layer_norm_eps
    x = x + _pos_conv_embed(p["pos_conv_embed"], x, cfg)
    if not cfg.do_stable_layer_norm:
        x = nn.layer_norm(p["layer_norm"], x, eps)
    for i in range(cfg.num_hidden_layers):
        lp = p["layers"][str(i)]
        if cfg.do_stable_layer_norm:
            x = x + _attention(lp["attention"], nn.layer_norm(lp["layer_norm"], x, eps),
                               cfg.num_attention_heads)
            x = x + _feed_forward(lp["feed_forward"],
                                  nn.layer_norm(lp["final_layer_norm"], x, eps))
        else:
            x = x + _attention(lp["attention"], x, cfg.num_attention_heads)
            x = nn.layer_norm(lp["layer_norm"], x, eps)
            x = nn.layer_norm(lp["final_layer_norm"], x + _feed_forward(lp["feed_forward"], x),
                              eps)
        if "adapter_layer" in lp:
            a = lp["adapter_layer"]
            h = nn.layer_norm(a["norm"], x, eps)
            x = x + nn.linear(a["linear_2"], torch.relu(nn.linear(a["linear_1"], h)))
    if cfg.do_stable_layer_norm:
        x = nn.layer_norm(p["layer_norm"], x, eps)
    return x


def trunk_forward(params: dict, waveform: torch.Tensor, cfg: Wav2Vec2Config) -> torch.Tensor:
    """waveform ``[B, T]`` -> hidden ``[B, T', D]``."""
    p = params["wav2vec2"] if "wav2vec2" in params else params
    with nn.f32_convolutions():
        feats = _feature_extractor(p["feature_extractor"], waveform, cfg)
        fp = p["feature_projection"]
        h = nn.linear(fp["projection"], nn.layer_norm(fp["layer_norm"], feats,
                                                      cfg.layer_norm_eps))
        return _encoder(p["encoder"], h, cfg)


def sanitize(weights: dict, keep_prefixes: tuple = ("wav2vec2.", "lm_head.", "projector.",
                                                    "classifier.")) -> dict:
    """HF checkpoint -> the tree's keys: the positional conv's weight norm
    folded (``weight_g``/``weight_v`` or the ``parametrizations`` names;
    the norm over dims (0, 1) in float64), ``masked_spec_embed`` and keys
    outside ``keep_prefixes`` dropped; conv weights stay ``[O, I, K]``."""
    out = {}
    wg = wv = None
    for k, v in weights.items():
        if "masked_spec_embed" in k or not any(k.startswith(p) for p in keep_prefixes):
            continue
        if (k.endswith("pos_conv_embed.conv.weight_g")
                or k.endswith("pos_conv_embed.conv.parametrizations.weight.original0")):
            wg = v
            continue
        if (k.endswith("pos_conv_embed.conv.weight_v")
                or k.endswith("pos_conv_embed.conv.parametrizations.weight.original1")):
            wv = v
            continue
        out[k] = v
    if wg is not None and wv is not None:
        norm = torch.sqrt((wv.to(torch.float64) ** 2).sum(dim=(0, 1), keepdim=True) + 1e-12)
        out["wav2vec2.encoder.pos_conv_embed.conv.weight"] = (wg * wv / norm).to(torch.float32)
    return out


def normalize(audio) -> np.ndarray:
    """Zero mean and unit variance over the last axis, on the host in
    NumPy f32 (population std + 1e-7); a 1-D input gains a batch axis."""
    x = np.asarray(audio, np.float32)
    if x.ndim == 1:
        x = x[None]
    return (x - x.mean(-1, keepdims=True)) / (x.std(-1, keepdims=True) + 1e-7)


def _first_device(params: dict) -> torch.device:
    return next(iter(loading.flatten(params).values())).device


class Wav2Vec2CTC:
    """CTC STT with MMS per-language adapters and vocabularies."""

    def __init__(self, config: Wav2Vec2Config, params: dict, vocab: dict[int, str],
                 vocabularies: dict[str, dict[int, str]] | None = None,
                 model_dir: str | None = None, dtype=torch.float32):
        self.config = config
        self.params = params
        self.vocab = vocab
        self.vocabularies = vocabularies or {}
        self.model_dir = model_dir
        self.dtype = dtype
        self.device = _first_device(params)

    @classmethod
    def from_pretrained(cls, repo_or_path: str, dtype=torch.float32, device="cuda",
                        quantize=None) -> "Wav2Vec2CTC":
        """Load a local HF checkpoint onto ``device``, with a flat or
        MMS-nested (one vocabulary a language) ``vocab.json``. ``quantize``
        is accepted for ``load_model``'s callers: any value but None
        raises."""
        if quantize is not None:
            raise ValueError(f"quantize={quantize!r}: wav2vec2 has no load-time quantization")
        model_dir = hub.resolve_model_dir(repo_or_path)
        config = Wav2Vec2Config.from_dict(hub.load_config(model_dir))
        params = loading.to_device(
            loading.load_params(model_dir, sanitize=sanitize, dtype=dtype), device)
        vocab, vocabularies = {}, {}
        vp = model_dir / "vocab.json"
        if vp.exists():
            raw = json.loads(vp.read_text())
            if raw and isinstance(next(iter(raw.values())), dict):
                vocabularies = {lang.lower(): {v: k for k, v in m.items()}
                                for lang, m in raw.items()}
                vocab = next(iter(vocabularies.values()))
            else:
                vocab = {v: k for k, v in raw.items()}
        return cls(config, params, vocab, vocabularies, str(model_dir), dtype)

    def load_adapter(self, language: str) -> bool:
        """Load MMS language-adapter weights (``adapter.<lang>.safetensors``
        beside the checkpoint) into the adapter layers; False when there
        is no such file."""
        if not self.model_dir:
            return False
        path = Path(self.model_dir) / f"adapter.{language.lower()}.safetensors"
        if not path.exists():
            return False
        merged = loading.flatten(self.params)
        for k, v in sanitize(loading.load_safetensors_file(path)).items():
            merged[k] = v.to(self.device, self.dtype)
        self.params = loading.unflatten(merged)
        return True

    def _vocab_for(self, language: str | None) -> dict[int, str]:
        if language and language.lower() in self.vocabularies:
            return self.vocabularies[language.lower()]
        return self.vocab

    @torch.no_grad()
    def logits(self, audio) -> torch.Tensor:
        """CTC logits ``[B, T', vocab]`` of the normalized waveform."""
        x = torch.from_numpy(normalize(audio)).to(self.device, self.dtype)
        return nn.linear(self.params["lm_head"], trunk_forward(self.params, x, self.config))

    def generate(self, audio, generation_parameters: STTGenerateParameters | None = None
                 ) -> STTOutput:
        """Greedy CTC: the argmax path with repeats and ``pad_token_id``
        (the blank) collapsed, ``|`` read as a space."""
        params = generation_parameters or STTGenerateParameters()
        t0 = time.perf_counter()
        n_samples = np.asarray(audio).shape[-1]
        best = self.logits(audio).argmax(-1)[0].tolist()
        blank = self.config.pad_token_id
        ids, prev = [], -1
        for t in best:
            if t != prev and t != blank:
                ids.append(t)
            prev = t
        vocab = self._vocab_for(params.language)
        text = "".join(vocab.get(t, "") for t in ids).replace("|", " ").strip()
        elapsed = time.perf_counter() - t0
        return STTOutput(text=text, language=params.language,
                         segments=[STTSegment(text=text, start=0.0, end=n_samples / 16000)],
                         generation_token_count=len(ids), total_time=elapsed,
                         generation_time=elapsed)

    def generate_stream(self, audio, generation_parameters=None):
        out = self.generate(audio, generation_parameters)
        if out.text:
            yield {"type": "token", "text": out.text}
        yield {"type": "result", "output": out}


def init_random_params(cfg: Wav2Vec2Config, seed: int = 0, dtype=torch.float32,
                       device=None, num_labels: int | None = None) -> dict:
    """Random params at ``cfg``'s shapes in the sanitized tree's layout,
    drawn on ``device`` from a ``torch.Generator`` seeded with ``seed``:
    linears and convs N(0, 1/fan-in), biases N(0, 0.02), norm weights
    1 + N(0, 0.1) and biases N(0, 0.02). A CTC head (``lm_head``) of
    ``cfg.vocab_size`` rows, and with ``num_labels`` the LID head
    (``projector`` to ``classifier_proj_size``, ``classifier``)."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(shape, std):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(std).to(dtype)

    def lin(o, i):
        return {"weight": rand((o, i), i ** -0.5), "bias": rand((o,), 0.02)}

    def norm(n):
        return {"weight": (1.0 + rand((n,), 0.1).float()).to(dtype), "bias": rand((n,), 0.02)}

    d, ffn = cfg.hidden_size, cfg.intermediate_size
    convs, c_in = {}, 1
    for i, (dim, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        conv = {"weight": rand((dim, c_in, k), (c_in * k) ** -0.5)}
        if cfg.conv_bias:
            conv["bias"] = rand((dim,), 0.02)
        layer = {"conv": conv}
        if cfg.feat_extract_norm == "layer" or i == 0:
            layer["layer_norm"] = norm(dim)
        convs[str(i)] = layer
        c_in = dim
    k, g = cfg.num_conv_pos_embeddings, cfg.num_conv_pos_embedding_groups
    layers = {str(i): {
        "attention": {n: lin(d, d) for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
        "layer_norm": norm(d), "final_layer_norm": norm(d),
        "feed_forward": {"intermediate_dense": lin(ffn, d), "output_dense": lin(d, ffn)}}
        for i in range(cfg.num_hidden_layers)}
    params = {"wav2vec2": {
        "feature_extractor": {"conv_layers": convs},
        "feature_projection": {"layer_norm": norm(c_in), "projection": lin(d, c_in)},
        "encoder": {"pos_conv_embed": {"conv": {"weight": rand((d, d // g, k),
                                                                (d // g * k) ** -0.5),
                                                 "bias": rand((d,), 0.02)}},
                    "layer_norm": norm(d), "layers": layers}},
        "lm_head": lin(cfg.vocab_size, d)}
    if num_labels:
        params["projector"] = lin(cfg.classifier_proj_size, d)
        params["classifier"] = lin(num_labels, cfg.classifier_proj_size)
    return params
