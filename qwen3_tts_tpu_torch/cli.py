"""qwen3-tts-cli on the PyTorch/CUDA port (port of qwen3_tts_tpu/cli.py):
``python -m qwen3_tts_tpu_torch.cli -m DIR -t TEXT -o OUT.wav``.

The flags, defaults, speaker-embedding cache and --serve stdin protocol
are the JAX package's CLI's:
  -m/--model, -t/--text, -o/--output, -r/--reference, -e/--embedding,
  --temperature, --top-k, --top-p, --max-tokens, --repetition-penalty,
  -j/--threads (accepted, unused), --serve, --seed, --language-id,
  --batch N (lock-step serving), --continuous, --max-frames;
  -r without -e caches the embedding to <reference>.embd;
  server: stdin lines "text\toutput.wav" -> stdout "OK\tdur\tms\tfile"
  or "ERR\tmsg"; 'quit'/'exit' stops.

One addition: --device (default cuda, the first card; cpu on request).
Without a card and without --device cpu the CLI exits 1.
"""

from __future__ import annotations

import argparse
import io
import os
import sys

import numpy as np

from .runtime import audio_io
from .runtime.pipeline import Qwen3TTS, TTSParams


def _err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="qwen3-tts-cli",
        description="Qwen3-TTS inference on PyTorch/CUDA")
    p.add_argument("-m", "--model", required=True, help="Model directory")
    p.add_argument("-t", "--text", help="Text to synthesize")
    p.add_argument("-o", "--output", default="output.wav",
                   help="Output WAV file (default: output.wav)")
    p.add_argument("-r", "--reference",
                   help="Reference audio for voice cloning")
    p.add_argument("-e", "--embedding",
                   help="Cached speaker embedding (.embd)")
    p.add_argument("--temperature", type=float, default=0.9,
                   help="Sampling temperature (default: 0.9, 0=greedy)")
    p.add_argument("--top-k", type=int, default=50,
                   help="Top-k sampling (default: 50, 0=disabled)")
    p.add_argument("--top-p", type=float, default=1.0,
                   help="Top-p sampling (default: 1.0)")
    p.add_argument("--max-tokens", type=int, default=4096,
                   help="Maximum audio tokens (default: 4096)")
    p.add_argument("--repetition-penalty", type=float, default=1.05,
                   help="Repetition penalty (default: 1.05)")
    p.add_argument("-j", "--threads", type=int, default=4,
                   help="Host threads (accepted for parity; unused)")
    p.add_argument("--serve", action="store_true",
                   help="Server mode: read requests from stdin")
    p.add_argument("--seed", type=int, default=None, help="Sampling seed")
    p.add_argument("--language-id", type=int, default=2050,
                   help="Codec language id (default 2050 = English)")
    p.add_argument("--batch", type=int, default=1,
                   help="Server mode: max concurrent lock-step streams")
    p.add_argument("--continuous", action="store_true",
                   help="Server mode: continuous batching — requests join "
                        "a running batch at 40-frame chunk boundaries")
    p.add_argument("--max-frames", type=int, default=1024,
                   help="Continuous mode: per-request frame cap")
    p.add_argument("--device", default="cuda",
                   help="Device to run on: cuda (default, the first card) "
                        "or cpu")
    return p


def resolve_embedding(tts: Qwen3TTS, embedding_file: str | None,
                      reference_audio: str | None) -> np.ndarray | None:
    """Load a cached embedding, or encode the reference audio and cache
    it; a cache of the wrong size is refused (and re-encoded when there
    is a reference)."""
    if not embedding_file:
        return None
    hidden = tts.talker_cfg.hidden_size if tts.talker_cfg else None
    emb = audio_io.load_embedding(embedding_file)
    if emb is not None and hidden is not None and len(emb) != hidden:
        # a stale or truncated cache would fail later inside the prefill
        # with a shape error: refuse it here, where the reference audio
        # can still be re-encoded
        _err(f"Warning: cached embedding {embedding_file} has {len(emb)} "
             f"floats, model expects {hidden}"
             + ("; re-encoding" if reference_audio else ""))
        emb = None
    if emb is not None and len(emb):
        _err(f"Loaded cached speaker embedding: {embedding_file} "
             f"({len(emb)} floats)")
        return emb
    if not reference_audio:
        _err("Error: embedding file not found and no --reference provided")
        return None
    _err(f"Encoding speaker embedding from: {reference_audio}")
    emb = tts.encode_speaker(reference_audio)
    if emb is None:
        _err(f"Error: {tts.error_msg}")
        return None
    if audio_io.save_embedding(embedding_file, emb):
        _err(f"Saved speaker embedding to: {embedding_file} "
             f"({len(emb)} floats)")
    return emb


def synthesize_one(tts: Qwen3TTS, text: str, speaker_embd, reference_audio,
                   params: TTSParams):
    if speaker_embd is not None:
        return tts.synthesize_with_embedding(text, speaker_embd, params)
    if reference_audio:
        return tts.synthesize_with_voice(text, reference_audio, params)
    return tts.synthesize(text, params)


def _parse_request_line(line: str):
    """One stdin TSV protocol line -> ("quit"|None|(text, out_file)).
    Shared by both server modes so they can never parse differently."""
    line = line.rstrip("\r\n")
    if not line:
        return None
    if line in ("quit", "exit"):
        return "quit"
    if "\t" in line:
        text, out_file = line.split("\t", 1)
    else:
        text, out_file = line, "output.wav"
    return text, out_file


class _LineSource:
    """Line reader that owns its buffer so "is another request already
    waiting?" is answerable. A bare select() on the fd is not enough:
    `for line in stream` readahead pulls every available byte into
    Python's internal buffer, after which select() reports not-ready
    while whole request lines sit buffered — a burst client piping N
    lines would be flushed one request per synthesize call, defeating
    --batch lock-step batching on real pipes. Reading the fd with
    os.read into our own buffer keeps readiness and readahead in the
    same place.

    Streams with no usable fileno (StringIO in tests, exotic platforms)
    fall back to stream.readline with more_ready()=True — batching then
    relies on the size/EOF triggers, as before."""

    def __init__(self, stream):
        self._stream = stream
        self._buf = b""
        self._eof = False
        try:
            self._fd = stream.fileno()
        except (OSError, ValueError, AttributeError,
                io.UnsupportedOperation):
            self._fd = None

    def _drain_ready(self) -> None:
        """Pull every byte the OS already has into our buffer without
        blocking (select first, read only what is ready)."""
        import select
        while not self._eof:
            try:
                ready = select.select([self._fd], [], [], 0.0)[0]
            except (OSError, ValueError):
                return
            if not ready:
                return
            chunk = os.read(self._fd, 65536)
            if not chunk:
                self._eof = True
                return
            self._buf += chunk

    def readline(self) -> str:
        """Next line (newline stripped by the caller's parser), or ''
        at EOF. Blocks until a full line or EOF arrives."""
        if self._fd is None:
            return self._stream.readline()
        while b"\n" not in self._buf and not self._eof:
            chunk = os.read(self._fd, 65536)     # blocking read
            if not chunk:
                self._eof = True
                break
            self._buf += chunk
        if b"\n" in self._buf:
            line, self._buf = self._buf.split(b"\n", 1)
            return line.decode("utf-8", errors="replace") + "\n"
        line, self._buf = self._buf, b""
        return line.decode("utf-8", errors="replace")

    def more_ready(self) -> bool:
        """True if another request line is already available — either
        buffered here or sitting in the OS pipe."""
        if self._fd is None:
            return True
        self._drain_ready()
        return b"\n" in self._buf or (self._eof and bool(self._buf))


def run_server(tts: Qwen3TTS, speaker_embd,
               params: TTSParams, batch: int = 1,
               stdin=None, stdout=None) -> int:
    """stdin TSV server loop, with opportunistic lock-step batching: up to `batch` queued requests
    synthesize together, but the queue flushes whenever stdin has no
    further line already buffered — a request/response client that waits
    for each OK before sending the next is never deadlocked waiting for
    the batch to fill."""
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    _err("\nServer ready. Send: text<TAB>output.wav  (or 'quit' to exit)")

    pending: list[tuple[str, str]] = []

    def flush_pending() -> None:
        if not pending:
            return
        texts = [t for t, _ in pending]
        embs = ([speaker_embd] * len(texts)
                if speaker_embd is not None else None)
        results = tts.synthesize_batch(texts, embs, params)
        for (text, out_file), res in zip(pending, results):
            if not res.success:
                stdout.write(f"ERR\t{res.error_msg}\n")
                stdout.flush()
                continue
            try:
                audio_io.save_wav(out_file, res.audio, res.sample_rate)
            except OSError:
                stdout.write(f"ERR\tfailed to save {out_file}\n")
                stdout.flush()
                continue
            dur = len(res.audio) / res.sample_rate
            stdout.write(f"OK\t{dur:.2f}\t{res.t_total_ms:.0f}\t{out_file}\n")
            stdout.flush()
            _err(f"  Done: {dur:.2f}s audio in {res.t_total_ms:.0f}ms "
                 f"(RTF={res.t_total_ms/1e3/max(dur,1e-9):.2f})")
        pending.clear()

    source = _LineSource(stdin)
    while True:
        line = source.readline()
        if not line:
            break
        req = _parse_request_line(line)
        if req is None:
            continue
        if req == "quit":
            break
        text, out_file = req
        _err(f'Synthesizing: "{text}" -> {out_file}')
        pending.append((text, out_file))
        if len(pending) >= max(batch, 1) or not source.more_ready():
            flush_pending()
    flush_pending()
    _err("Server shutting down.")
    return 0


def run_server_continuous(tts: Qwen3TTS, speaker_embd, params: TTSParams,
                          n_slots: int, max_frames: int,
                          stdin=None, stdout=None) -> int:
    """Continuous-batching server: same stdin TSV protocol, but requests
    are admitted into a running batch at chunk boundaries instead of being
    processed serially. A reader thread feeds the request queue so
    generation never blocks on input."""
    import queue
    import threading

    from .runtime.serve import ContinuousBatcher

    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout

    requests: "queue.Queue[tuple[str, str] | None]" = queue.Queue()

    def reader() -> None:
        for line in stdin:
            req = _parse_request_line(line)
            if req is None:
                continue
            if req == "quit":
                break
            requests.put(req)
        requests.put(None)

    cb = ContinuousBatcher(tts, n_slots=n_slots, params=params,
                           max_frames=max_frames)
    # build every serving executable (CUDA graphs on the card, the
    # kernels' nvcc build) before the first line is read, so that no
    # request pays a first-use stall
    cb.warmup()
    threading.Thread(target=reader, daemon=True).start()
    _err(f"\nServer ready (continuous, {n_slots} slots). "
         "Send: text<TAB>output.wav  (or 'quit' to exit)")
    outputs: dict[int, str] = {}
    eof = False
    while not eof or cb.pending():
        # admit everything queued right now
        while True:
            try:
                item = requests.get_nowait()
            except queue.Empty:
                break
            if item is None:
                eof = True
                break
            text, out_file = item
            rid = cb.submit(text, speaker_embd)
            outputs[rid] = out_file
            _err(f'Admitted: "{text}" -> {out_file}')
        if not cb.pending():
            if eof:
                break
            # idle: block for the next request
            item = requests.get()
            if item is None:
                break
            text, out_file = item
            rid = cb.submit(text, speaker_embd)
            outputs[rid] = out_file
            continue
        for rid, res in cb.step().items():
            out_file = outputs.pop(rid, "output.wav")
            if not res.success:
                stdout.write(f"ERR\t{res.error_msg}\n")
                stdout.flush()
                continue
            try:
                audio_io.save_wav(out_file, res.audio, res.sample_rate)
            except OSError:
                stdout.write(f"ERR\tfailed to save {out_file}\n")
                stdout.flush()
                continue
            dur = len(res.audio) / res.sample_rate
            stdout.write(f"OK\t{dur:.2f}\t{res.t_total_ms:.0f}\t{out_file}\n")
            stdout.flush()
    _err("Server shutting down.")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if not args.serve and not args.text:
        _err("Error: text is required (or use --serve)")
        return 1

    params = TTSParams(
        max_audio_tokens=args.max_tokens,
        temperature=args.temperature,
        top_p=args.top_p,
        top_k=args.top_k,
        repetition_penalty=args.repetition_penalty,
        language_id=args.language_id,
        seed=args.seed,
    )

    tts = Qwen3TTS()
    _err(f"Loading models from: {args.model} onto {args.device}")
    if not tts.load_models(args.model, device=args.device):
        _err(f"Error: {tts.error_msg}")
        return 1

    # -r without -e caches the embedding to <reference>.embd
    embedding_file = args.embedding
    if not embedding_file and args.reference:
        embedding_file = args.reference + ".embd"
    speaker_embd = None
    if embedding_file:
        speaker_embd = resolve_embedding(tts, embedding_file, args.reference)
        if speaker_embd is None:
            return 1

    if args.serve:
        if args.continuous:
            n_slots = max(args.batch, 2)
            if n_slots != args.batch:
                _err(f"Note: continuous mode needs >= 2 slots; "
                     f"using {n_slots} (requested --batch {args.batch})")
            return run_server_continuous(tts, speaker_embd, params,
                                         n_slots, args.max_frames)
        return run_server(tts, speaker_embd, params, args.batch)

    _err(f'Synthesizing: "{args.text}"')
    res = synthesize_one(tts, args.text, speaker_embd, args.reference, params)
    if not res.success:
        _err(f"\nError: {res.error_msg}")
        return 1
    try:
        audio_io.save_wav(args.output, res.audio, res.sample_rate)
    except OSError as e:
        _err(f"Error: failed to save output file: {e}")
        return 1
    _err(f"Output saved to: {args.output}")
    _err(f"Audio duration: {len(res.audio)/res.sample_rate:.2f} seconds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
