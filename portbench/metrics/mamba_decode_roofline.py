"""``mamba_decode_roofline`` (%): the least time the card could take for
every ``mamba_decode`` launch of the traced batch over the device time its
kernels took.  A launch takes one Mamba2 layer of the batch's rows through
everything between its two projections (:func:`mamba_decode_cost`).  Layer:
the kernels (``kernels/ops.py`` -> ``csrc/mamba_decode.cu``).  Nothing to
read unless the trace holds exactly one launch a Mamba2 layer and step: so
it is also the check that the kernel takes every layer of every step."""

from portbench import cost, peaks

F32 = 4  # the state, its conv window, and a_log, d_skip, dt_bias are float32


def mamba_decode_cost(m: dict, batch: int) -> tuple:
    """``(FLOPs, bytes)`` of one launch for ``batch`` rows.  Bytes: the
    float32 state ``[B, H, 64, d_state]`` and conv window ``[B, K - 1, C]``
    (C = d_inner + 2 d_state) each read and written once; the projection's
    z, xBC and dt read; ``conv_w [K, C]``, ``norm_z [d_inner]`` and the three
    float32 per-head vectors read; the gated y written.  FLOPs: the conv's
    K taps a channel, and the state's decay, update and read (5 an entry)."""
    d_inner = m["ssm_expand"] * m["d_model"]
    heads = max(1, d_inner // 64)
    ds, K = m["ssm_state"], m["ssm_conv"]
    C = d_inner + 2 * ds
    act = cost.ACT_BYTES
    nbytes = (2 * F32 * batch * d_inner * ds            # the state
              + 2 * F32 * batch * (K - 1) * C           # the conv window
              + act * batch * (d_inner + C + heads)     # z, xBC, dt
              + act * (K * C + d_inner) + F32 * 3 * heads  # conv_w, norm_z; per-head vectors
              + act * batch * d_inner)                  # the gated y
    return batch * (2 * K * C + 5 * d_inner * ds), nbytes


def read(obs):
    tr = obs.device_trace
    if tr is None:
        return None
    secs, n = tr.kernel_seconds(lambda name: "mamba_decode_kernel" in name)
    if n == 0 or n != cost.blocks(obs.model).count("mamba") * obs.steps:
        return None
    bound = peaks.bound_s(obs.kind, *mamba_decode_cost(obs.model, obs.batch))
    if bound is None:
        return None
    return 100.0 * n * bound / secs
