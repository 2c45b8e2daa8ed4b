"""Mimi on the PyTorch port against the JAX package, on the CPU in f32:
offline codes and waveforms, streamed decode and encode, the registry, the
parameter crossing, and the streaming cache's end.

Two checkpoints in the MLX layout: the fixture as written
(tests/fixtures.make_mimi_fixture, periodic weights) and "rand", a copy
with seeded normal weights and EMA codebooks whose ``cluster_usage`` is not
all ones. Codes must be equal; where they part, the test asserts the
witness (:func:`assert_codes_or_witness`): the JAX package's two best
distances at the first parted code lie within the two packages' difference
of those distances, and the rest of that frame is not compared.
Tolerances: 1e-5 on waveforms against the JAX package, 1e-4 for streamed
decode against offline (the JAX package's own test's limit).
"""

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.codecs import load_codec as jload_codec
from tpu_audio.codecs import mimi as JM
from tpu_audio.core import loading as jloading
from tpu_audio_torch.codecs import load_codec as tload_codec
from tpu_audio_torch.codecs import mimi as TM

from fixtures import make_mimi_fixture

torch.set_num_threads(1)

WAV_ATOL = 1e-5
STREAM_ATOL = 1e-4
HOP = 8  # the fixture's samples a frame: ratios 2 x 2, downsample stride 2


def _randomize(src, dst, seed):
    """A copy of the Mimi checkpoint ``src`` with N(0, 1/sqrt(fan-in))
    weights, norms 1 + N(0, 0.1), biases N(0, 0.05), and EMA codebooks of
    ``cluster_usage`` in [0.5, 4) and ``embedding_sum`` N(0, 1) rows times
    their usage."""
    from safetensors.numpy import save_file

    shutil.copytree(src, dst)
    rng = np.random.default_rng(seed)
    out = {}
    flat = jloading.load_safetensors(src)
    for name, v in sorted(flat.items()):  # a codebook's cluster_usage before its embedding_sum
        if name.endswith("cluster_usage"):
            a = rng.uniform(0.5, 4.0, v.shape)
        elif name.endswith("embedding_sum"):
            a = rng.standard_normal(v.shape) * out[name[:-13] + "cluster_usage"][:, None]
        elif name.endswith("initialized") or ".scale" in name:
            a = v
        elif "norm" in name:
            a = 1.0 + 0.1 * rng.standard_normal(v.shape)
        elif name.endswith(".bias"):
            a = 0.05 * rng.standard_normal(v.shape)
        else:
            a = rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[1:]))
        out[name] = np.asarray(a, np.float32)
    save_file(out, str(dst / "model.safetensors"))
    return dst


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mimi")
    fix = make_mimi_fixture(root / "fixture")
    return {"fixture": fix, "rand": _randomize(fix, root / "rand", 21)}


@pytest.fixture(scope="module")
def models(dirs):
    built = {}

    def get(which):
        if which not in built:
            built[which] = (JM.Mimi.from_pretrained(str(dirs[which])),
                            TM.Mimi.from_pretrained(str(dirs[which]), device="cpu"))
        return built[which]

    return get


def _audio(seed, n):
    return (np.random.default_rng(seed).standard_normal(n) * 0.2).astype(np.float32)


def _vq_distances(mimi_params, latent, layer_path):
    """The JAX package's distances ``|e|^2 / 2 - x . e`` of each row of
    ``latent`` to each codebook row of the VQ layer at ``layer_path``."""
    p = mimi_params
    for k in layer_path:
        p = p[k]
    emb = np.asarray(JM._codebook_embed(p["codebook"]), np.float64)
    return (emb ** 2).sum(-1) / 2 - latent.astype(np.float64) @ emb.T


def assert_codes_or_witness(got, want, witness):
    """``got`` equals ``want`` ([B, n_q, T]), or at each frame's first
    parted codebook ``q`` both codes are among the two best of
    ``distances(b, q, t)`` (the reference's distances there, with their
    difference between the packages as ``gap``), which lie within ``gap``:
    a near tie that summation order decides. ``witness()`` builds
    ``distances`` where codes part."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    frames = {(b, t) for b, _, t in np.argwhere(got != want)}
    distances = witness() if frames else None
    for b, t in sorted(frames):
        q = int(np.flatnonzero(got[b, :, t] != want[b, :, t])[0])
        d, gap = distances(b, q, t)
        best = np.sort(d)[:2]
        assert {int(got[b, q, t]), int(want[b, q, t])} <= set(np.argsort(d)[:2].tolist())
        assert best[1] - best[0] <= gap, (b, q, t, best, gap)


def _encode_witness(jm, tm, audio):
    """``distances(b, q, t)`` for :func:`assert_codes_or_witness` on an
    offline encode: each package's residual before codebook ``q``, the JAX
    package's distances from it, and the largest difference of the two
    packages' distances as the gap."""
    jp, tp = jm.params, tm.params
    cfg = tm.config
    x = torch.from_numpy(audio)[None, :, None]
    with torch.no_grad():
        h = TM.seanet_encode(tp["encoder"], x, cfg.seanet)
        h, _ = TM.transformer_forward(tp["encoder_transformer"], h, cfg.transformer)
        s = cfg.downsample_stride
        t_lat = TM.s_conv1d(tp["downsample"], h, 2 * s, stride=s, pad_mode="edge")
    jh = JM.seanet_encode(jp["encoder"], jnp.asarray(audio)[None, :, None], jm.config.seanet)
    jh, _ = JM.transformer_forward(jp["encoder_transformer"], jh, jm.config.transformer)
    j_lat = np.asarray(JM.s_conv1d(jp["downsample"], jh, 2 * s, stride=s, pad_mode="edge"))
    t_lat = t_lat.numpy()
    n_first = len(jp["quantizer"]["rvq_first"]["vq"]["layers"])
    want = np.asarray(jm.encode(audio))

    def distances(b, q, t):
        part, i = ("rvq_first", q) if q < n_first else ("rvq_rest", q - n_first)
        pp = jp["quantizer"][part]
        w = np.asarray(pp["input_proj"]["weight"])[:, :, 0]
        xs = {}
        for name, lat in (("j", j_lat), ("t", t_lat)):
            r = lat[b, t] @ w.T
            for k in range(i):  # the residual before codebook i, by the reference's codes
                emb = np.asarray(JM._codebook_embed(pp["vq"]["layers"][str(k)]["codebook"]))
                r = r - emb[want[b, (0 if part == "rvq_first" else n_first) + k, t]]
            xs[name] = r
        dj = _vq_distances(jp, xs["j"][None], ("quantizer", part, "vq", "layers", str(i)))[0]
        dt = _vq_distances(jp, xs["t"][None], ("quantizer", part, "vq", "layers", str(i)))[0]
        return dj, float(np.abs(dj - dt).max()) * 2

    return distances


# -- offline ------------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["fixture", "rand"])
def test_encode_codes_match_jax(models, which):
    jm, tm = models(which)
    audio = _audio(1, 203)
    got = tm.encode(audio)
    assert got.dtype == torch.int64 and got.shape == (1, 4, -(-203 // HOP))
    assert_codes_or_witness(got.numpy(), np.asarray(jm.encode(audio)),
                            lambda: _encode_witness(jm, tm, audio))


@pytest.mark.parametrize("which", ["fixture", "rand"])
def test_decode_matches_jax(models, which):
    jm, tm = models(which)
    codes = np.random.default_rng(2).integers(0, 16, (2, 4, 12))
    got = tm.decode(codes).numpy()
    want = np.asarray(jm.decode(codes))
    assert got.shape == want.shape == (2, 12 * HOP)
    np.testing.assert_allclose(got, want, atol=WAV_ATOL)


def test_reconstruct_and_batch_rows_match_alone(models):
    jm, tm = models("rand")
    audio = np.stack([_audio(3, 96), _audio(4, 96)])
    codes = tm.encode(audio)
    for b in range(2):
        np.testing.assert_array_equal(codes[b:b + 1].numpy(), tm.encode(audio[b]).numpy())
    np.testing.assert_allclose(tm.reconstruct(audio).numpy(),
                               np.asarray(jm.decode(np.asarray(jm.encode(audio)))),
                               atol=WAV_ATOL)


# -- streaming --------------------------------------------------------------------------------


JAX_SPLITS = [(0, 6), (6, 12)]  # the JAX package's steps compile a graph a shape: two


@pytest.mark.parametrize("which", ["fixture", "rand"])
@pytest.mark.parametrize("splits", [[(0, 3), (3, 4), (4, 9), (9, 12)],
                                    [(i, i + 1) for i in range(12)], JAX_SPLITS])
def test_streamed_decode_matches_offline_and_jax(models, which, splits):
    """Uneven chunks against offline; the JAX package's stream in
    ``JAX_SPLITS``."""
    jm, tm = models(which)
    codes = np.random.default_rng(5).integers(0, 16, (1, 4, 12))
    offline = tm.decode(codes).numpy()
    dec = TM.MimiStreamingDecoder(tm)
    got = np.concatenate([dec.decode_frames(codes[:, :, s:e]) for s, e in splits], axis=-1)
    assert got.shape[-1] == offline.shape[-1] == 12 * HOP
    np.testing.assert_allclose(got, offline[:, :got.shape[-1]], atol=STREAM_ATOL)
    if splits is JAX_SPLITS:
        jdec = JM.MimiStreamingDecoder(jm)
        want = np.concatenate([jdec.decode_frames(codes[:, :, s:e]) for s, e in splits],
                              axis=-1)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=WAV_ATOL)


@pytest.mark.parametrize("which", ["fixture", "rand"])
@pytest.mark.parametrize("splits", [[(0, 24), (24, 40), (40, 96)],
                                    [(0, 5), (5, 7), (7, 60), (60, 61), (61, 96)]])
def test_encode_step_codes_match_offline(models, which, splits):
    jm, tm = models(which)
    audio = _audio(6, 96)
    offline = tm.encode(audio).numpy()
    tm.reset_state()
    pieces = [tm.encode_step(audio[None, s:e]).numpy() for s, e in splits]
    assert all(p.shape[:2] == (1, 4) and p.dtype == np.int64 for p in pieces)
    streamed = np.concatenate(pieces, axis=-1)
    assert 0 < streamed.shape[-1] <= offline.shape[-1]
    np.testing.assert_array_equal(streamed, offline[:, :, :streamed.shape[-1]])


def test_decode_step_raises_past_the_cache_where_jax_clamps(models):
    """2,040 transformer positions (1,020 frames), then 12 more: the port
    raises, naming the cache's 2,048 positions, and keeps its stream state
    for a reset. The JAX package, its cache set at the same position, runs
    on past its end (its write clamps) and says nothing."""
    jm, tm = models("rand")
    codes = np.random.default_rng(8).integers(0, 16, (1, 4, 1026))
    tm.reset_state()
    assert tm.decode_step(codes[:, :, :1020]).shape == (1, 1020 * HOP)
    with pytest.raises(ValueError, match="2052 transformer positions pass the cache's 2048"):
        tm.decode_step(codes[:, :, 1020:])
    assert TM.STREAM_CACHE_LEN == 2048 and tm._dec_cache.offset == 2040
    jm.reset_state()
    jm._dec_cache = jm._dec_cache._replace(offset=jnp.int32(2040))
    tail = np.asarray(jm.decode_step(codes[:, :, 1020:]))  # JAX_SPLITS' first shape
    assert np.isfinite(tail).all() and int(jm._dec_cache.offset) == 2052 > 2048
    tm.reset_state()
    assert tm.decode_step(codes[:, :, :6]).shape == (1, 6 * HOP)


# -- registry, parameters ----------------------------------------------------------------------


def test_load_codec_finds_mimi(dirs, tmp_path):
    codec = tload_codec(str(dirs["fixture"]), device="cpu")
    assert isinstance(codec, TM.Mimi) and isinstance(jload_codec(str(dirs["fixture"])), JM.Mimi)
    assert codec.sample_rate == 24000 and codec.config.downsample_stride == 2
    untyped = tmp_path / "mimi_untyped"
    shutil.copytree(dirs["fixture"], untyped)
    cfg = json.loads((untyped / "config.json").read_text())
    del cfg["model_type"]
    (untyped / "config.json").write_text(json.dumps(cfg))
    assert isinstance(tload_codec(str(untyped), device="cpu"), TM.Mimi)


def test_from_jax_params_carries_the_mimi_tree(models):
    from tpu_audio_torch.convert import from_jax_params

    from test_torch_ops import jax_tree_to_numpy

    jm, tm = models("rand")
    t = TM.Mimi(tm.config, from_jax_params(jax_tree_to_numpy(jm.params)))
    audio = _audio(9, 80)
    np.testing.assert_array_equal(t.encode(audio).numpy(), tm.encode(audio).numpy())
    codes = np.random.default_rng(9).integers(0, 16, (1, 4, 6))
    np.testing.assert_array_equal(t.decode(codes).numpy(), tm.decode(codes).numpy())


def test_init_random_params_matches_the_loaded_tree(models):
    """The random tree has the loaded tree's shapes, without what a
    mimi-202407 checkpoint lacks (the transformers' input and output
    projections) and the codebooks' ``initialized`` flags; its codebooks'
    usage is not all ones."""
    _, tm = models("fixture")
    rand = TM.init_random_params(tm.config)

    def shapes(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(shapes(v, f"{prefix}{k}."))
            else:
                out[prefix + k] = tuple(v.shape)
        return out

    got, want = shapes(rand), shapes(tm.params)
    extra = {k for k in want if "input_proj" in k and "transformer" in k
             or "output_projs" in k or k.endswith("initialized")}
    assert got == {k: v for k, v in want.items() if k not in extra}
    usage = rand["quantizer"]["rvq_rest"]["vq"]["layers"]["1"]["codebook"]["cluster_usage"]
    assert float(usage.min()) >= 0.5 and float(usage.std()) > 0.1
    wav = TM.Mimi(tm.config, rand).decode(np.zeros((1, 4, 3), np.int64))
    assert wav.shape == (1, 3 * HOP) and bool(torch.isfinite(wav).all())
