"""``launches_per_step`` (launches/step): the device kernels the traced
batch ran, over the engine's steps for it (prompt steps and decode steps,
from ``ServeEngine.stats``).  Layer: the model step
(``models/model.py::Model.decode_step``)."""


def read(obs):
    tr = obs.device_trace
    if tr is None or not tr.complete or obs.steps <= 0:
        return None
    return len(tr.kernels) / obs.steps
