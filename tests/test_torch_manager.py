"""Port parity: the management tables of `repro_torch` against the JAX
package and its numpy oracle (`reference_manager_np`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, assert_equal

from repro.core import manager as jmgr
from repro_torch.core import manager as tmgr


def _cuts(rng, n, frames, churn):
    cut = rng.random(n) < 0.3
    seq = [cut.copy()]
    for _ in range(frames - 1):
        cut = np.where(rng.random(n) < churn, ~cut, cut)
        seq.append(cut.copy())
    return np.stack(seq)


@pytest.mark.parametrize("seed,w_star,churn", [(0, 4, 0.05), (1, 8, 0.2), (2, 1, 0.4)])
def test_tables_exact(seed, w_star, churn):
    cuts = _cuts(np.random.default_rng(seed), 300, 20, churn)
    n = cuts.shape[1]
    ref_delta, ref_res = jmgr.reference_manager_np(cuts, w_star=w_star)
    jc, jcl = jmgr.ManagerState.initial(n), jmgr.ClientState.initial(n)
    tc, tcl = tmgr.ManagerState.initial(n, CPU), tmgr.ClientState.initial(n, CPU)
    for t, cut in enumerate(cuts):
        jc, jp = jmgr.cloud_sync(jc, jnp.asarray(cut), jnp.int32(t), jnp.int32(w_star))
        tc, tp = tmgr.cloud_sync(tc, torch.from_numpy(cut), t, w_star)
        for f in ("delta_data", "cut_add", "cut_remove", "evicted", "n_delta", "n_resident"):
            assert_equal(getattr(tp, f), getattr(jp, f), f)
        for f in ("client_has", "last_used", "cut_prev"):
            assert_equal(getattr(tc, f), getattr(jc, f), f)
        assert int(tp.n_delta) == ref_delta[t] and int(tp.n_resident) == ref_res[t]
        assert float(tp.wire_bytes(30.0)) == float(jp.wire_bytes(30.0))
        jcl = jmgr.client_sync(jcl, jp.delta_data, jp.cut_add, jp.cut_remove,
                               jnp.int32(t), jnp.int32(w_star))
        tcl = tmgr.client_sync(tcl, tp.delta_data, tp.cut_add, tp.cut_remove, t, w_star)
        for f in ("has", "last_used", "cut"):
            assert_equal(getattr(tcl, f), getattr(jcl, f), f)
        assert_equal(tcl.has, tc.client_has)


@pytest.mark.parametrize("budget", [8, 64])
def test_gather_payload(budget):
    mask = np.random.default_rng(3).random(100) < 0.2
    jids, jn = jmgr.gather_payload(None, jnp.asarray(mask), budget)
    tids, tn = tmgr.gather_payload(None, torch.from_numpy(mask), budget)
    assert_equal(tids, jids)
    assert int(tn) == int(jn) and tids.dtype == torch.int32
    assert (tmgr.ID_BYTES, tmgr.ID_BYTES_DELTA, tmgr.SYNC_HEADER_BYTES,
            tmgr.POSE_UPLINK_BYTES) == (jmgr.ID_BYTES, jmgr.ID_BYTES_DELTA,
                                        jmgr.SYNC_HEADER_BYTES, jmgr.POSE_UPLINK_BYTES)
