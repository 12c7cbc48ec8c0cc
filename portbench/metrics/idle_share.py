"""``idle_share`` (%): the share of the traced batch's seconds in which no
operation ran on the device, 1 - the union of the device's event intervals
over the batch's span.  Layer: the device."""


def read(obs):
    tr = obs.device_trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
