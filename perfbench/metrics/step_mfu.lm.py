"""The whole consensus step against the chip's bfloat16 peak, in %: the
model operations a step requires (``bounds.lm_step_flops``: forward and
backward of every acting worker's tokens in each local step, at the
configuration's reference model's operations a token) over the
traced steps' wall time per step, against 989 TFLOP/s."""
from perfbench import bounds


def read(run):
    s, w = run.summary, run.work
    if s.iterations <= 0:
        return None
    flops = bounds.lm_step_flops(w["token_flops"], w["tokens_per_step"],
                                 w["local_steps"])
    return 100.0 * flops / bounds.PEAK_BF16_FLOPS / (s.window_s / s.iterations)
