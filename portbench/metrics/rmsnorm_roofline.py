"""``rmsnorm_roofline`` (%): the least time the card could take for every
``rmsnorm`` launch of the traced batch over the device time its kernels
took; each launch normalizes the batch's rows of ``d_model``
(``cost.rmsnorm_cost``: x and the gain read, y written).  Layer: the kernels
(``kernels/ops.py`` -> ``csrc/rmsnorm.cu``).  Nothing to read unless the
trace holds the norms a step applies (``cost.norms_per_step``) at every step."""

from portbench import cost, peaks


def read(obs):
    tr = obs.device_trace
    if tr is None:
        return None
    secs, n = tr.kernel_seconds(lambda name: "rmsnorm_kernel" in name)
    if n == 0 or n != cost.norms_per_step(obs.model) * obs.steps:
        return None
    bound = peaks.bound_s(obs.kind, *cost.rmsnorm_cost(obs.model, obs.batch))
    if bound is None:
        return None
    return 100.0 * n * bound / secs
