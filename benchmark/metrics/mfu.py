"""Model operations of every frame delivered inside the window and of the
prefill of every request whose first audio came in it, as the cell's
architecture counts them (``frame_flops``, ``prefill_flops``: the counts
the rooflines use), over the window times the chip's bf16 peak, in %. So
it bounds a gain after a kernel leaves the path."""

from benchmark import roofline


def read(run):
    arch, m = run.cell.arch, run.cell.model
    spf, P = m.vocoder.samples_per_frame, m.prefill_len
    a, b = run.t_window0, run.t_window1
    base = arch.frame_flops(m, 0)          # linear in the position
    slope = arch.frame_flops(m, 1) - base
    total = 0.0
    for s in run.streams:
        seen = 0
        for j, (t, n) in enumerate(s.events):
            f0, k = seen // spf, n // spf
            seen += n
            if not a <= t <= b:
                continue
            if j == 0:
                total += arch.prefill_flops(m, len(s.req.tokens), P)
            total += k * base + slope * k * (P + f0 + (k - 1) / 2)
    if not run.window_s > 0:
        return None
    return 100.0 * total / (run.window_s * roofline.PEAK_FLOPS)
