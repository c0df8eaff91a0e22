"""The enc-dec, Zamba2 and xLSTM families' `loss` and its gradient for
every parameter against `jax.value_and_grad(model.loss)` on the CPU, in
float32 at `reduced` size (xlstm at 7 blocks, so that an sLSTM block is in
the gradient), with `tests/test_torch_loss.py`'s tolerances.

Zamba2 is held at JAX's own init values of Mamba2's A_log and dt_bias (the
other constant leaves seeded). With them seeded too, some heads decay
fast enough that the SSD chunk's weights exp(cum_i − cum_j) overflow above
the diagonal, where JAX masks them after the exp (`repro/models/mamba2.py`
`ssd_chunked`), so JAX's gradients hold NaN (0·inf) in every leaf the
backward reaches through an SSD: the embed and every Mamba2 and shared
block leaf. The port masks before the exp, and its gradients stay finite
(`test_zamba2_ssd_overflow_is_a_fault_of_the_reference`).

xLSTM's gradients are held within 2e-4 of each leaf's largest |grad|.
Its float32 recurrences drift from JAX's with depth (the two packages
order the mLSTM chunk products differently), and the backward widens the
drift: measured on a CPU at 7 blocks, the largest gap is 1.02e-4 of a
leaf's scale at 32 tokens (this test) and 1.24e-4 at 40 tokens. JAX's own
float32 gradients are as far from the exact ones: run in float64 (the
same JAX code with its float32 casts made float64) at 40 tokens, JAX's
float32 gradients differ from them by up to 1.30e-4 of a leaf's scale,
the port's by up to 1.20e-4."""

import numpy as np
import pytest

from _torch_parity import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_loss import check_family, family_case

pytestmark = pytest.mark.usefixtures("one_torch_thread")

XLSTM_SCALE_TOL = 2e-4


@pytest.mark.parametrize("name,over,init_leaves", [
    ("seamless-m4t-medium", {}, ()),
    ("zamba2-2.7b", {}, ("A_log", "dt_bias")),
    ("xlstm-350m", dict(n_layers=7), ())])
def test_family_loss_and_grads_match_jax(name, over, init_leaves):
    check_family(family_case(name, over, init_leaves),
                 XLSTM_SCALE_TOL if name == "xlstm-350m" else 0.0)


def test_zamba2_ssd_overflow_is_a_fault_of_the_reference():
    """With A_log and dt_bias seeded, JAX's Zamba2 gradients hold NaN in
    the embed and in every leaf of the groups and the shared block; the
    port's are finite and non-zero, and the two losses agree within 1e-5
    (the forward never differed: both weights are 0 above the diagonal)."""
    case = family_case("zamba2-2.7b")
    np.testing.assert_allclose(case["loss"], case["jloss"], rtol=1e-5)
    upstream = [k for k in case["jgrads"] if k == "embed" or k.startswith(("groups/", "shared/"))]
    assert len(upstream) == len(case["jgrads"]) - 2          # all but final_norm, unembed
    assert all(np.isnan(case["jgrads"][k]).any() for k in upstream)
    for k, g in case["grads"].items():
        assert np.isfinite(g).all() and np.abs(g).max() > 0, k
