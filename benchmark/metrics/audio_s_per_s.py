"""Audio seconds delivered to callers (``on_chunk`` / ``on_audio``) inside
the window, over the window's length (host clock)."""


def read(run):
    if not run.window_s > 0:
        return None
    sr = run.cell.model.vocoder.sample_rate
    return run.audio_in_window_s(sr) / run.window_s
