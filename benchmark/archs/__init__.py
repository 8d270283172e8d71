"""Model architectures, one file each: ``benchmark/archs/<arch>.py``, named
by the ``"arch"`` key of a configuration file (benchmark/configs/) and
loaded by benchmark/spec.py with the cell. The harness reaches a model's
layers only through the surface below, so a new architecture enters as
new files: its arch file, its configuration, its limits
(benchmark/limits/), and traffic or metric files where it needs them.
Shared layers are libraries an arch file imports: benchmark/model.py
(dense stack and vocoder shapes), weights.py (``Spec``, the stack and
vocoder leaves), reference/layers.py and reference/vocoder.py, roofline.py
(peaks, ``bound_s``, ``share_pct``, stack and vocoder counts) and
program.py (the vocoder's configuration). An arch may import another
arch's module for the parts it shares with it.

An arch file defines:

Shapes
    ``load(raw) -> m``: the configuration file's dict as the model. The
    harness reads ``m.special`` (the template's token ids),
    ``m.text_vocab``, ``m.n_codebooks``, ``m.prefill_len`` (rows of a
    request's prefill) and ``m.vocoder`` (a model.Vocoder:
    ``sample_rate``, ``samples_per_frame``).

Weights
    ``make_weights(m, seed, device) -> weights.Weights``: every leaf from
    the seed on the device; the same seed gives the same bits, which is
    how the check's reference gets them again.

Reference (plain torch; ``p`` a reference.layers.Prec, ``w`` the
``talker`` weights, ``v`` ``m.vocoder``; what check.compare calls)
    ``talker_sequence(p, w, m, tokens, speaker, codes) -> (rows, P)``:
    the talker's input for a request that served codes [F, 16];
    ``talker_hidden(p, w, m, seqs) -> [hidden [T, H]]``;
    ``cb0_scores(p, w, m, hidden, codes, n_tokens, penalty) -> [F, V]``:
    the first codebook's scores as the sampler sees them;
    ``code_logits(p, w, m, hidden, codes) -> [F, 15, V]``;
    ``vocode(p, vocoder_weights, v, codes [B, T, 16]) -> [B, T * spf]``.

Counts (benchmark/roofline.py's rules)
    ``talker_step(m, B, n_past)``, ``codepred_frame(m, B)``,
    ``vocoder_chunk(m, n)``: (operations, bytes) of one call;
    ``prefill_flops(m, n_tokens, P)``, ``frame_flops(m, n_past)``:
    operations of a request's prefill and of one delivered frame (mfu).

Program adapter
    ``make_engine(m, weights, tokenizer, device)``: the program's
    ``Qwen3TTS`` engine, with the configuration objects it takes;
    ``layer_calls(run, engine, B)``: a generator of ``(layer, call,
    iterations, capture, (operations, bytes))``, one layer at a time, for
    benchmark/timing.py (``capture`` False for a call that replays the
    program's own graphs); it frees a layer's inputs before the next.
"""
