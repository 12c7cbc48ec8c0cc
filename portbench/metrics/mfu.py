"""``mfu`` (%): the model's FLOPs for the traced batch's real tokens (padding
left out; ``cost.served_flops``) over the batch's seconds on the profiler's
clock times the card's bfloat16 peak (``peaks.py``).  Layer: the whole step."""

from portbench import cost, peaks


def read(obs):
    tr = obs.device_trace
    peak = peaks.peak(obs.kind, "bf16_flops")
    if tr is None or peak is None:
        return None
    flops = cost.served_flops(obs.model, obs.prompt_lens, obs.traffic["new_tokens"])
    return 100.0 * flops / (tr.window_s * peak)
