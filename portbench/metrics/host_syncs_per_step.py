"""``host_syncs_per_step`` (syncs/step): the engine's reads of the device's
results on the host (``ServeEngine.stats["host_syncs"]``: a decode step's
sampled tokens, and a batch's new tokens at its end) over the traced
batch's decode steps.  Layer: the serving engine (``serving/engine.py``),
whose every read waits for the device to finish the work before it.  None
where the engine keeps no such counter."""


def read(obs):
    steps = obs.stats.get("decode_steps", 0)
    if "host_syncs" not in obs.stats or steps <= 0:
        return None
    return obs.stats["host_syncs"] / steps
