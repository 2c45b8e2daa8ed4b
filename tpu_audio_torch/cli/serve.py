"""Transcription, speech, VAD, language-ID and enhancement HTTP server on
the PyTorch port (port of the STT, TTS, VAD, LID and STS routes of
tpu_audio.cli.serve).
Endpoints follow the OpenAI audio API paths:

- ``POST /v1/audio/transcriptions``: body = raw WAV bytes
  (``curl --data-binary @in.wav``); JSON out: text/segments/language +
  wall time. STT models.
- ``POST /v1/audio/transcriptions/stream``: same body; chunked
  ``application/x-ndjson``: one ``{"type": "token", "text": ...}`` line per
  transcribed 30 s window, then a final ``{"type": "result", ...}`` line.
- ``POST /v1/audio/speech``: JSON body ``{"input": "...", "voice": ...,
  "max_tokens": ..., "seed": ...}``; WAV bytes out. TTS models. Voice
  cloning: ``"ref_audio_b64"`` (base64 WAV bytes) + ``"ref_text"``.
- ``POST /v1/audio/speech/stream``: same body; chunked raw PCM16
  (``Content-Type: audio/L16; rate=<sr>``), each synthesized chunk flushed
  as the model emits it.
- ``POST /v1/audio/vad``: raw WAV in; JSON speech segments. Sortformer:
  ``{"segments": [{"start", "end", "speaker"}], "num_speakers"}`` from
  ``generate``; FSMN VAD: ``{"segments": [{"start", "end"}]}`` from
  ``detect``'s spans; Silero: the same from the speech segmenter's runs
  (seconds, rounded to ms). Requests take turns on the model under the lock.
  SmartTurn has no VAD route, as in the JAX server.
- ``POST /v1/audio/lid``: raw WAV in; JSON ``{"language", "confidence",
  "top": [{"language", "confidence"}, ...]}`` (``?top_k=N``, default 5).
  ECAPA-TDNN: concurrent requests go through a micro-batcher (one
  ``predict_batch`` a 4 ms window of up to 16 requests); MMS-LID
  (wav2vec2), which has no ``predict_batch``: ``predict`` under the lock.
- ``POST /v1/audio/enhance``: raw WAV in (resampled to the model's rate),
  enhanced WAV out at that rate. STS enhancement models (DeepFilterNet):
  ``enhance`` under the lock.
- ``GET /healthz``: liveness + model metadata.
- ``GET /metrics``: Prometheus text format: per-route request/error counts
  and wall-time totals.

With ``--slots N`` (N > 1) concurrent requests share continuously batched
decode lanes: Whisper transcriptions of up to 30 s and Qwen3-ASR ones of up
to 20 s through ``parallel.continuous_stt.STTEngineWorker`` (Qwen3-ASR on
``ContinuousQwen3ASR``; other STT models, such as Parakeet, Cohere
Transcribe, MOSS-Transcribe-Diarize and wav2vec2 CTC, answer every request
through ``generate`` under the lock, and
a Qwen3 forced aligner, which needs a transcript, answers with an error),
Orpheus speech through ``parallel.continuous.TTSEngineWorker`` and
Qwen3-TTS speech through
``parallel.continuous_qwen3.Qwen3TTSEngineWorker`` (one lane-batched frame
a tick; no reference-audio cloning), with the sampling parameters then
fixed per server; otherwise, and for longer audio, requests take turns on
the model under a lock. Start with:

    python -m tpu_audio_torch.cli.serve --model DIR --task tts --quantize w8a8 --slots 4
    python -m tpu_audio_torch.cli.serve --model QWEN3_TTS_DIR --task tts --slots 4
    python -m tpu_audio_torch.cli.serve --model SORTFORMER_DIR --task vad
    python -m tpu_audio_torch.cli.serve --model ECAPA_DIR --task lid
    python -m tpu_audio_torch.cli.serve --model MMS_LID_DIR --task lid
    python -m tpu_audio_torch.cli.serve --model DEEPFILTERNET_DIR --task sts

The flags are the JAX server's, plus ``--device`` and ``--quantize w8a8``
(int8 weights: the configuration whose serving tick runs a fused lanes
kernel). ``--task auto`` finds the task through the port's STT, TTS, VAD,
LID and STS registries. The ``codec`` task, ``--tp > 1`` and ``--warmup``
are not ported yet and stop with a message.
"""

from __future__ import annotations

import argparse
import io
import json
import tempfile
import threading
import time
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

__all__ = ["main", "build_server"]

TASKS = ("stt", "tts", "vad", "lid", "sts")  # the tasks the port serves


def _wav_bytes(audio: np.ndarray, sample_rate: int) -> bytes:
    from tpu_audio_torch.core.audio_io import float_to_pcm16

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(float_to_pcm16(audio).tobytes())
    return buf.getvalue()


def _load_wav_body(body: bytes, target_sr: int | None):
    from tpu_audio_torch.core.audio_io import load_audio

    with tempfile.NamedTemporaryFile(suffix=".wav") as f:
        f.write(body)
        f.flush()
        return load_audio(f.name, sample_rate=target_sr)


def _ref_audio(req: dict, model):
    """Decode the request's base64-WAV cloning reference, if any."""
    if not req.get("ref_audio_b64"):
        return None
    import base64

    audio, _ = _load_wav_body(base64.b64decode(req["ref_audio_b64"]),
                              getattr(model, "sample_rate", 24000))
    return audio


_KNOWN_ROUTES = (
    "/v1/audio/transcriptions", "/v1/audio/transcriptions/stream",
    "/v1/audio/speech", "/v1/audio/speech/stream", "/v1/audio/enhance",
    "/v1/audio/lid", "/v1/audio/vad", "/healthz", "/metrics",
)


class _Metrics:
    """Per-route counters in Prometheus text exposition format.

    Label values are the closed set of known routes (+ ``other``), never
    the raw request path: unique scanner paths must not grow the label
    space unboundedly or inject quotes/newlines into the exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests: dict[str, int] = {}
        self.errors: dict[str, int] = {}
        self.wall: dict[str, float] = {}

    def observe(self, route: str, seconds: float, error: bool) -> None:
        route = route.split("?", 1)[0].rstrip("/") or "/"
        if route not in _KNOWN_ROUTES:
            route = "other"
        with self._lock:
            self.requests[route] = self.requests.get(route, 0) + 1
            self.wall[route] = self.wall.get(route, 0.0) + seconds
            if error:
                self.errors[route] = self.errors.get(route, 0) + 1

    def render(self) -> str:
        lines = [
            "# TYPE tpu_audio_requests_total counter",
            "# TYPE tpu_audio_errors_total counter",
            "# TYPE tpu_audio_request_seconds_total counter",
        ]
        with self._lock:
            for route, n in sorted(self.requests.items()):
                lines.append(
                    f'tpu_audio_requests_total{{route="{route}"}} {n}')
                lines.append(
                    f'tpu_audio_request_seconds_total{{route="{route}"}} '
                    f'{self.wall[route]:.6f}')
            for route, n in sorted(self.errors.items()):
                lines.append(
                    f'tpu_audio_errors_total{{route="{route}"}} {n}')
        return "\n".join(lines) + "\n"


class _LIDBatcher:
    """Micro-batches concurrent ``/v1/audio/lid`` requests into one
    ``predict_batch`` call: its thread drains what arrived within WINDOW_S
    of the first request (up to MAX_BATCH) and classifies it in one padded,
    masked call a length bucket. The thread is the only user of the device
    for this task (PyTorch's default stream, as the request threads would
    use), so no lock is taken; an error unblocks every waiter of its
    batch."""

    WINDOW_S, MAX_BATCH = 0.004, 16

    def __init__(self, model):
        import queue

        self.model = model
        self._q: queue.Queue = queue.Queue()
        self._empty = queue.Empty
        self._thread = threading.Thread(target=self._run, daemon=True, name="lid-batcher")
        self._thread.start()

    def predict(self, audio, top_k: int):
        done = threading.Event()
        box: dict = {}
        self._q.put((audio, int(top_k), done, box))
        done.wait()
        if "err" in box:
            raise box["err"]
        return box["out"]

    def close(self) -> None:
        """Stop the thread after the requests already queued."""
        self._q.put(None)
        self._thread.join(timeout=60)

    def _run(self) -> None:
        from tpu_audio_torch.models.lid.wav2vec2_lid import LIDOutput

        while True:
            first = self._q.get()
            if first is None:
                return
            batch, stop = [first], False
            deadline = time.perf_counter() + self.WINDOW_S
            while len(batch) < self.MAX_BATCH:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    item = self._q.get(timeout=left)
                except self._empty:
                    break
                if item is None:
                    stop = True
                    break
                batch.append(item)
            try:
                k_max = max(k for _, k, _, _ in batch)
                outs = self.model.predict_batch([a for a, _, _, _ in batch], top_k=k_max)
                for (_, k, done, box), o in zip(batch, outs):
                    box["out"] = LIDOutput(o.language, o.confidence, o.top_languages[:k])
                    done.set()
            except Exception as e:  # noqa: BLE001 — unblock every waiter
                for _, _, done, box in batch:
                    box["err"] = e
                    done.set()
            if stop:
                return


class _Server(ThreadingHTTPServer):
    """The HTTP server; closing it also stops the engine workers and the
    LID micro-batcher."""

    daemon_threads = True
    stt_worker = None
    tts_worker = None
    lid_batcher = None

    def server_close(self) -> None:
        super().server_close()
        for worker in (self.stt_worker, self.tts_worker, self.lid_batcher):
            if worker is not None:
                worker.close()


def _segments(out) -> list[dict]:
    return [{"text": s.text, "start": s.start, "end": s.end}
            for s in (out.segments or [])]


def _vad_payload(model, audio: np.ndarray) -> dict:
    """The VAD route's JSON: Sortformer's speaker segments through
    ``generate``, FSMN's ms spans through ``detect``, Silero's speech runs
    through the segmenter (the JAX route's order)."""
    if hasattr(model, "generate"):  # diarization
        out = model.generate(audio)
        return {"segments": [{"start": round(float(s.start), 3), "end": round(float(s.end), 3),
                              "speaker": int(s.speaker)} for s in out["segments"]],
                "num_speakers": out["num_speakers"]}
    if hasattr(model, "detect"):  # FSMN: [start_ms, end_ms] spans
        return {"segments": [{"start": round(s / 1000.0, 3), "end": round(e / 1000.0, 3)}
                             for s, e in model.detect(audio, 16000)]}
    from tpu_audio_torch.models.vad.segmenter import SpeechSegmentConfig, detect_speech_runs

    runs = detect_speech_runs(audio, 16000, model, SpeechSegmentConfig())
    return {"segments": [{"start": round(s / 16000.0, 3), "end": round(e / 16000.0, 3)}
                         for s, e in runs]}


def build_server(model, task: str, model_name: str,
                 host: str = "127.0.0.1", port: int = 8080,
                 slots: int = 1, generation_parameters=None,
                 step_tokens: int = 7, fused: str = "auto"):
    """Construct (but don't start) the HTTP server for an STT (``task``
    "stt": Whisper, Parakeet, Qwen3-ASR, Cohere Transcribe,
    MOSS-Transcribe-Diarize, wav2vec2 CTC), TTS (``task`` "tts": Orpheus,
    Qwen3-TTS), VAD (``task`` "vad": Silero, Sortformer, FSMN VAD), LID
    (``task`` "lid": ECAPA-TDNN through a micro-batcher, MMS-LID through
    ``predict`` under the lock) or STS (``task`` "sts": DeepFilterNet)
    ``model``.

    ``slots > 1`` routes Whisper transcriptions of up to 30 s, and Qwen3-ASR
    ones of up to its engine's window (20 s), through a shared
    :class:`~tpu_audio_torch.parallel.continuous_stt.STTEngineWorker`,
    Orpheus speech through a shared
    :class:`~tpu_audio_torch.parallel.continuous.TTSEngineWorker` and
    Qwen3-TTS speech through a shared
    :class:`~tpu_audio_torch.parallel.continuous_qwen3.Qwen3TTSEngineWorker`
    (with ``generation_parameters`` fixed per server; ``max_tokens``,
    ``seed`` and ``voice`` stay per request): concurrent requests decode
    together in one continuously batched tick instead of serializing on the
    model lock. ``server_close()`` stops the workers.
    """
    if task not in TASKS:
        raise NotImplementedError(
            f"task {task!r} is not ported yet: the PyTorch server serves {TASKS}")
    lock = threading.Lock()
    metrics = _Metrics()
    stt_worker = tts_worker = None
    if slots > 1 and task == "stt":
        from tpu_audio_torch.models.stt.qwen3_aligner import Qwen3ForcedAligner
        from tpu_audio_torch.models.stt.qwen3_asr import Qwen3ASR
        from tpu_audio_torch.models.stt.whisper import Whisper

        # other STT models answer through generate; so does a forced aligner
        # (a Qwen3ASR whose head classifies times, not tokens): its locked
        # generate names the missing transcript
        if (isinstance(model, (Whisper, Qwen3ASR))
                and not isinstance(model, Qwen3ForcedAligner)):
            from tpu_audio_torch.parallel.continuous_stt import (ContinuousQwen3ASR,
                                                                 STTEngineWorker)

            # Qwen3-ASR's engine takes no fused tick
            engine = ({"engine_cls": ContinuousQwen3ASR} if isinstance(model, Qwen3ASR)
                      else {"fused": fused})
            stt_worker = STTEngineWorker(model, slots=slots, step_tokens=step_tokens, **engine)
    elif slots > 1 and task == "tts":
        from tpu_audio_torch.models.tts.qwen3_tts import Qwen3TTS

        if isinstance(model, Qwen3TTS):
            from tpu_audio_torch.parallel.continuous_qwen3 import Qwen3TTSEngineWorker

            tts_worker = Qwen3TTSEngineWorker(model, slots=slots,
                                              generation_parameters=generation_parameters)
        else:
            from tpu_audio_torch.parallel.continuous import TTSEngineWorker

            tts_worker = TTSEngineWorker(model, slots=slots,
                                         generation_parameters=generation_parameters,
                                         step_tokens=step_tokens, fused=fused)
    # a model with predict_batch (ECAPA) takes the micro-batcher; one
    # without it (MMS-LID) answers each request under the lock
    lid_batcher = (_LIDBatcher(model) if task == "lid" and hasattr(model, "predict_batch")
                   else None)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, payload: bytes,
                  ctype: str = "application/json") -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode())

        def _body(self) -> bytes | None:
            """Request body, or None when no Content-Length was sent
            (chunked encoding would desync the keep-alive connection)."""
            if self.headers.get("Content-Length") is None:
                return None
            return self.rfile.read(int(self.headers["Content-Length"]))

        def _stream_chunks(self, ctype: str, chunks) -> None:
            """Chunked transfer encoding: flush each piece as it arrives."""
            self._streaming = True
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            for piece in chunks:
                data = bytes(piece)
                if not data:
                    continue
                self.wfile.write(f"{len(data):x}\r\n".encode())
                self.wfile.write(data)
                self.wfile.write(b"\r\n")
                self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")

        def _speech_batched(self, req: dict) -> None:
            """A speech request through the continuous-batching worker: its
            events arrive as the shared engine steps, so many connections
            synthesize at once on one device."""
            from tpu_audio_torch.core.audio_io import float_to_pcm16
            from tpu_audio_torch.core.generation import AudioGenerationKind

            events = tts_worker.synthesize(
                req.get("input", ""), voice=req.get("voice"),
                ref_audio=_ref_audio(req, model), ref_text=req.get("ref_text"),
                max_tokens=(int(req["max_tokens"])
                            if req.get("max_tokens") is not None else None),
                seed=int(req.get("seed") or 0))
            try:
                chunks = (np.asarray(ev.audio) for ev in events
                          if ev.kind == AudioGenerationKind.AUDIO)
                if self.path.endswith("/stream"):
                    self._stream_chunks(f"audio/L16; rate={model.sample_rate}",
                                        (float_to_pcm16(c).tobytes() for c in chunks))
                else:
                    parts = [c for c in chunks if c.size]
                    wav = np.concatenate(parts) if parts else np.zeros((0,), np.float32)
                    self._send(200, _wav_bytes(wav, model.sample_rate), "audio/wav")
            finally:
                # a client gone mid-stream cancels the request and frees its
                # decode lane at once
                events.close()

        def _speech(self, req: dict) -> None:
            """A speech request on the model itself, under the lock."""
            from tpu_audio_torch.core.audio_io import float_to_pcm16
            from tpu_audio_torch.core.generation import samples_stream

            # cloning arguments only when supplied
            clone = {}
            ra = _ref_audio(req, model)
            if ra is not None:
                clone = {"ref_audio": ra, "ref_text": req.get("ref_text")}
            params = model.default_generation_parameters()
            if req.get("max_tokens") is not None:
                params.max_tokens = int(req["max_tokens"])
            if req.get("seed") is not None:
                params.seed = int(req["seed"])
            if self.path.endswith("/stream"):
                def pcm_chunks():
                    with lock:
                        for chunk in samples_stream(model, req.get("input", ""),
                                                    voice=req.get("voice"),
                                                    generation_parameters=params, **clone):
                            yield float_to_pcm16(chunk).tobytes()

                self._stream_chunks(f"audio/L16; rate={model.sample_rate}", pcm_chunks())
            else:
                with lock:
                    wav = model.generate(req.get("input", ""), voice=req.get("voice"),
                                         generation_parameters=params, **clone)
                self._send(200, _wav_bytes(wav, model.sample_rate), "audio/wav")

        def do_GET(self):  # noqa: N802 — http.server API
            if self.path == "/healthz":
                self._json(200, {"ok": True, "task": task,
                                 "model": model_name})
            elif self.path == "/metrics":
                self._send(200, metrics.render().encode(),
                           "text/plain; version=0.0.4")
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802 — http.server API
            t_start = time.perf_counter()
            failed = False
            self._streaming = False
            try:
                body = self._body()
                if body is None:
                    self.close_connection = True
                    failed = True
                    self._json(411, {"error": "Content-Length required"})
                    return
                if self.path == "/v1/audio/transcriptions/stream" and task == "stt":
                    audio, _ = _load_wav_body(body, 16000)

                    def ndjson():
                        with lock:
                            for ev in model.generate_stream(audio):
                                if ev.get("type") == "result":
                                    out = ev["output"]
                                    ev = {"type": "result", "text": out.text,
                                          "language": out.language,
                                          "segments": _segments(out)}
                                yield (json.dumps(ev) + "\n").encode()

                    self._stream_chunks("application/x-ndjson", ndjson())
                elif self.path == "/v1/audio/transcriptions" and task == "stt":
                    audio, _ = _load_wav_body(body, 16000)
                    t0 = time.perf_counter()
                    if (stt_worker is not None
                            and len(audio) <= stt_worker._srv.window):
                        # window-sized requests share the continuously
                        # batched decode lanes; long-form takes the
                        # chunked offline path under the lock
                        out = stt_worker.transcribe(audio)
                    else:
                        with lock:
                            out = model.generate(audio)
                    self._json(200, {
                        "text": out.text,
                        "language": out.language,
                        "segments": _segments(out),
                        "wall_s": round(time.perf_counter() - t0, 3),
                    })
                elif (self.path in ("/v1/audio/speech", "/v1/audio/speech/stream")
                      and task == "tts"):
                    req = json.loads(body or b"{}")
                    if tts_worker is not None:
                        self._speech_batched(req)
                    else:
                        self._speech(req)
                elif self.path.split("?")[0] == "/v1/audio/lid" and task == "lid":
                    from urllib.parse import parse_qs, urlparse

                    top_k = int(parse_qs(urlparse(self.path).query).get("top_k", ["5"])[0])
                    audio, _ = _load_wav_body(body, 16000)
                    if lid_batcher is not None:
                        out = lid_batcher.predict(audio, top_k)
                    else:
                        with lock:
                            out = model.predict(audio, top_k=top_k)
                    self._json(200, {
                        "language": out.language,
                        "confidence": round(out.confidence, 6),
                        "top": [{"language": p.language, "confidence": round(p.confidence, 6)}
                                for p in out.top_languages],
                    })
                elif self.path == "/v1/audio/vad" and task == "vad":
                    audio, _ = _load_wav_body(body, 16000)
                    with lock:
                        self._json(200, _vad_payload(model, audio))
                elif self.path == "/v1/audio/enhance" and task == "sts":
                    audio, sr = _load_wav_body(body, model.sample_rate)
                    with lock:
                        out = model.enhance(audio)
                    self._send(200, _wav_bytes(out, sr), "audio/wav")
                else:
                    failed = True
                    self._json(404, {"error":
                                     f"no route {self.path} for task {task}"})
            except Exception as e:  # noqa: BLE001 — report, don't kill server
                failed = True
                if self._streaming:
                    # headers already sent: a JSON 500 here would corrupt
                    # the chunked body; drop the connection instead, which
                    # the client sees as a truncated (invalid) stream
                    self.close_connection = True
                else:
                    self._json(500, {"error": f"{type(e).__name__}: {e}"})
            finally:
                metrics.observe(self.path, time.perf_counter() - t_start,
                                failed)

    server = _Server((host, port), Handler)
    server.stt_worker, server.tts_worker = stt_worker, tts_worker
    server.lid_batcher = lid_batcher
    return server


def detect_task(model_dir: str) -> str | None:
    """The task whose model registry (``tpu_audio_torch.models.<task>``)
    holds the checkpoint's ``model_type``, or None."""
    import importlib

    from tpu_audio_torch.core import hub

    model_type = hub.resolve_model_type(hub.load_config(model_dir))
    for task in TASKS:
        if model_type in importlib.import_module(f"tpu_audio_torch.models.{task}")._REGISTRY:
            return task
    return None


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        "tpu-audio-torch-serve", description=__doc__.splitlines()[0])
    parser.add_argument("--model", required=True)
    parser.add_argument("--task", default="auto",
                        choices=("auto", "stt", "tts", "sts", "lid",
                                 "codec", "vad"))
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--slots", type=int, default=1,
                        help="continuous-batching decode lanes (>1 lets "
                             "concurrent requests share the decoder; "
                             "sampling params become per-server; a "
                             "Qwen3-TTS model serves through "
                             "ContinuousQwen3TTS, an MLX tree on CUDA at "
                             "most 32 lanes)")
    parser.add_argument("--fused", default="auto", choices=("auto", "off"),
                        help="the fused lanes tick for w8a8 whisper and "
                             "Orpheus (auto takes it when supported; off "
                             "serves with the plain per-lane tick, which a "
                             "w8a8 tree on CUDA does not take)")
    parser.add_argument("--step-tokens", type=int, default=7,
                        help="decode tokens per tick under --slots "
                             "(amortizes host work; tokens are identical "
                             "for any value; a Qwen3-TTS tick is one "
                             "frame)")
    parser.add_argument("--warmup", action="store_true",
                        help="precompile steady-state graphs before "
                             "accepting traffic (not ported yet)")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel degree (not ported yet: 1)")
    parser.add_argument("--device", default="cuda", help="torch device")
    parser.add_argument("--quantize", default=None, choices=("w8a8",),
                        help="int8 weights at load time")
    args = parser.parse_args(argv)

    if args.tp > 1:
        raise SystemExit("--tp > 1: tensor-parallel serving is not ported yet")
    if args.warmup:
        raise SystemExit("--warmup: not ported yet")
    task = args.task
    if task == "auto":
        from tpu_audio_torch.core import hub

        task = detect_task(hub.resolve_model_dir(args.model))
        if task is None:
            raise SystemExit("cannot infer a servable task; pass --task")
    if task not in TASKS:
        raise SystemExit(f"--task {task}: not ported yet; the PyTorch server "
                         f"serves {', '.join(TASKS)}")

    if task == "stt":
        from tpu_audio_torch.models.stt import load_model

        model = load_model(args.model, device=args.device, quantize=args.quantize)
    elif task == "tts":
        from tpu_audio_torch.models.tts import load_model

        model = load_model(args.model, device=args.device, quantize_bits=args.quantize)
    else:
        if args.quantize is not None:
            raise SystemExit(f"--quantize {args.quantize}: the {task.upper()} models have "
                             "no load-time quantization")
        import importlib

        model = importlib.import_module(f"tpu_audio_torch.models.{task}").load_model(
            args.model, device=args.device)
    server = build_server(model, task, args.model, args.host, args.port,
                          slots=args.slots, step_tokens=args.step_tokens,
                          fused=args.fused)
    print(json.dumps({"serving": args.model, "task": task,
                      "addr": f"http://{args.host}:{args.port}"}), flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
