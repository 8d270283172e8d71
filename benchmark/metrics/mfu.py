"""Model operations of every frame delivered inside the window (the
talker step, the code predictor, the vocoder's share of its chunk) and
of the prefill of every request whose first audio came in it, over the
window times the chip's bf16 peak, in %. It counts by the functions the
rooflines use, so it bounds a gain after a kernel leaves the path."""

from benchmark import roofline


def read(run):
    m = run.cell.model
    spf, P = m.vocoder.samples_per_frame, m.prefill_len
    a, b = run.t_window0, run.t_window1
    base = roofline.frame_flops(m, 0)          # linear in the position
    slope = roofline.frame_flops(m, 1) - base
    total = 0.0
    for s in run.streams:
        seen = 0
        for j, (t, n) in enumerate(s.events):
            f0, k = seen // spf, n // spf
            seen += n
            if not a <= t <= b:
                continue
            if j == 0:
                total += roofline.prefill_flops(m, len(s.req.tokens), P)
            total += k * base + slope * k * (P + f0 + (k - 1) / 2)
    if not run.window_s > 0:
        return None
    return 100.0 * total / (run.window_s * roofline.PEAK_FLOPS)
