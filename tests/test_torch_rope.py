"""The port's rotary frequencies and cos / sin tables against
``repro.models.attention.rope_cos_sin``.

The frequencies ``theta ** (-i / half)`` are held bit for bit at every head
dim the configs use (GQA 64, 80, 112, 128, 192, 256; MLA's rotary 32 and 64;
the reduced configs' 16), at theta 1e4 and 1e6: XLA gives the correctly
rounded float32 values, and torch's float32 ``pow`` misses them by one ulp
at a few indices (D 256, theta 1e4: 11, 33, 84, 102, 124), an error that
positions multiply.  The tables are then held to 3e-5 (the reference's
float32 ``_tol``) at every position up to 131071.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jatt
from repro_torch.models import attention

HEAD_DIMS = [16, 32, 64, 80, 112, 128, 192, 256]
THETAS = [1e4, 1e6]


@pytest.mark.parametrize("theta", THETAS)
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_rope_frequencies_are_the_reference_bit_for_bit(head_dim, theta):
    half = head_dim // 2
    want = np.asarray(theta ** (-jnp.arange(0, half, dtype=jnp.float32) / half))
    got = attention._rope_freqs(half, theta, torch.device("cpu")).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_torch_float32_pow_misses_the_correctly_rounded_frequencies():
    # why the port raises theta in float64: the plain float32 form differs
    half = 128
    plain = (1e4 ** (-torch.arange(0, half, dtype=torch.float32) / half)).numpy()
    want = np.asarray(1e4 ** (-jnp.arange(0, half, dtype=jnp.float32) / half))
    assert np.flatnonzero(plain != want).tolist() == [11, 33, 84, 102, 124]


@pytest.mark.parametrize("theta", THETAS)
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_rope_tables_agree_up_to_position_131071(head_dim, theta):
    pos = np.arange(131072, dtype=np.int32).reshape(2, -1)
    jc, js = jatt.rope_cos_sin(jnp.asarray(pos), head_dim, theta)
    c, s = attention.rope_cos_sin(torch.from_numpy(pos), head_dim, theta)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=3e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=3e-5)
