"""``decode_attention_roofline`` (%): the least time the card could take for
every ``decode_attention`` launch of the traced batch over the device time
its kernels took.  A step at position t attends t + 1 filled slots in each
attention block (``cost.decode_attention_cost``: the query, each row's
filled keys and values, the output).  Layer: the kernels
(``kernels/ops.py`` -> ``csrc/decode_attention.cu``).  Nothing to read
unless the trace holds exactly one launch an attention block and step."""

from portbench import cost, peaks


def read(obs):
    tr = obs.device_trace
    if tr is None:
        return None
    secs, n = tr.kernel_seconds(lambda name: "decode_attention_kernel" in name)
    per_step = cost.attention_launches(obs.model)
    if n == 0 or n != per_step * obs.steps:
        return None
    least = 0.0
    for pos in range(obs.steps):
        flops, nbytes = cost.decode_attention_cost(obs.model, obs.batch, pos + 1)
        bound = peaks.bound_s(obs.kind, flops, nbytes)
        if bound is None:
            return None
        least += per_step * bound
    return 100.0 * least / secs
