"""The port's recurrent cores against the JAX package's on the CPU, on the
same seeded float32 inputs: Mamba2's `ssd_chunked` (with and without a
carried state, padded and unpadded chunks), `ssd_step`, `_causal_conv`
with and without its state, and xLSTM's `mlstm_chunked` (its state carried
across calls), `mlstm_recurrent_step` and `slstm_scan` (with a state).
Tolerance 1e-4 rtol/atol unless stated."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as jm
from repro.models import xlstm as jx
from repro_torch.models import mamba2, xlstm

from _torch_parity import assert_close

TOL = 1e-4


def _ssd_inputs(rng, b, s, h, p, n):
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.abs(rng.normal(0.5, 0.3, (b, s, h))).astype(np.float32)
    A = -np.abs(rng.normal(1, 0.3, h)).astype(np.float32)
    B = rng.normal(size=(b, s, n)).astype(np.float32)
    C = rng.normal(size=(b, s, n)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("s,chunk,carried", [(16, 4, False), (29, 8, False), (29, 29, True),
                                             (12, 64, True), (37, 8, True)])
def test_ssd_chunked_matches_jax(s, chunk, carried):
    rng = np.random.default_rng(s * 7 + chunk)
    b, h, p, n = 2, 3, 8, 6
    ins = _ssd_inputs(rng, b, s, h, p, n)
    state = rng.normal(size=(b, h, p, n)).astype(np.float32) if carried else None
    jy, jst = jm.ssd_chunked(*(jnp.asarray(a) for a in ins), chunk=chunk,
                             state=None if state is None else jnp.asarray(state))
    y, st = mamba2.ssd_chunked(*(torch.from_numpy(a) for a in ins), chunk=chunk,
                               state=None if state is None else torch.from_numpy(state))
    assert y.dtype == st.dtype == torch.float32
    assert_close(y, jy, TOL, TOL, "y")
    assert_close(st, jst, TOL, TOL, "state")


def test_ssd_chunked_carry_equals_one_call():
    """Two calls with the state carried == one call over the whole sequence."""
    rng = np.random.default_rng(0)
    x, dt, A, B, C = (torch.from_numpy(a) for a in _ssd_inputs(rng, 1, 24, 2, 4, 3))
    full, st_full = mamba2.ssd_chunked(x, dt, A, B, C, chunk=5)
    y1, st = mamba2.ssd_chunked(x[:, :11], dt[:, :11], A, B[:, :11], C[:, :11], chunk=5)
    y2, st2 = mamba2.ssd_chunked(x[:, 11:], dt[:, 11:], A, B[:, 11:], C[:, 11:], chunk=5,
                                 state=st)
    assert_close(torch.cat([y1, y2], 1), full, TOL, TOL)
    assert_close(st2, st_full, TOL, TOL)


def test_ssd_step_matches_jax():
    rng = np.random.default_rng(1)
    b, h, p, n = 3, 4, 8, 5
    state = rng.normal(size=(b, h, p, n)).astype(np.float32)
    x = rng.normal(size=(b, h, p)).astype(np.float32)
    dt = np.abs(rng.normal(0.5, 0.3, (b, h))).astype(np.float32)
    A = -np.abs(rng.normal(1, 0.3, h)).astype(np.float32)
    Bv, Cv = (rng.normal(size=(b, n)).astype(np.float32) for _ in range(2))
    jst, jy = jm.ssd_step(*(jnp.asarray(a) for a in (state, x, dt, A, Bv, Cv)))
    st, y = mamba2.ssd_step(*(torch.from_numpy(a) for a in (state, x, dt, A, Bv, Cv)))
    assert_close(st, jst, TOL, TOL, "state")
    assert_close(y, jy, TOL, TOL, "y")


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(2)
    b, s, c, k = 2, 7, 10, 4
    x = rng.normal(size=(b, s, c)).astype(np.float32)
    w = (rng.normal(size=(k, c)) * 0.2).astype(np.float32)
    st = rng.normal(size=(b, k - 1, c)).astype(np.float32) if with_state else None
    jy, jst = jm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                              None if st is None else jnp.asarray(st))
    y, nst = mamba2._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                 None if st is None else torch.from_numpy(st))
    assert_close(y, jy, 1e-6, 1e-6, "y")
    assert_close(nst, jst, 0, 0, "state")


def test_causal_conv_state_carries_a_sequence():
    """The step form (one token at a time, state carried) == the whole
    sequence at once."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 9, 6)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(4, 6)) * 0.2).astype(np.float32))
    full, _ = mamba2._causal_conv(x, w)
    st = torch.zeros((2, 3, 6))
    steps = []
    for t in range(9):
        y, st = mamba2._causal_conv(x[:, t:t + 1], w, st)
        steps.append(y)
    assert_close(torch.cat(steps, 1), full, 1e-6, 1e-6)


def _mlstm_inputs(rng, b, s, h, d):
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3))
    log_f = (-np.abs(rng.normal(0, 1, (b, s, h)))).astype(np.float32)
    log_i = rng.normal(0, 1, (b, s, h)).astype(np.float32)
    return q, k, v, log_f, log_i


@pytest.mark.parametrize("s,chunk", [(16, 4), (37, 8), (33, 33), (20, 64)])
def test_mlstm_chunked_matches_jax(s, chunk):
    rng = np.random.default_rng(s * 131 + chunk)
    ins = _mlstm_inputs(rng, 2, s, 3, 8)
    jh, jst = jx.mlstm_chunked(*(jnp.asarray(a) for a in ins), chunk=chunk)
    h, st = xlstm.mlstm_chunked(*(torch.from_numpy(a) for a in ins), chunk=chunk)
    assert_close(h, jh, TOL, TOL, "h")
    for i, name in enumerate("cnm"):
        assert_close(st[i], jst[i], TOL, TOL, name)


def test_mlstm_chunked_state_carry_matches_jax():
    """Two chunked calls with the state carried, in both packages, and
    against one call over the whole sequence."""
    rng = np.random.default_rng(0)
    ins = _mlstm_inputs(rng, 1, 24, 2, 4)
    t_ins = [torch.from_numpy(a) for a in ins]
    j_ins = [jnp.asarray(a) for a in ins]
    full, _ = xlstm.mlstm_chunked(*t_ins, chunk=6)
    h1, st = xlstm.mlstm_chunked(*(a[:, :12] for a in t_ins), chunk=6)
    h2, st2 = xlstm.mlstm_chunked(*(a[:, 12:] for a in t_ins), chunk=6, state=st)
    assert_close(torch.cat([h1, h2], 1), full, TOL, TOL)
    _jh1, jst = jx.mlstm_chunked(*(a[:, :12] for a in j_ins), chunk=6)
    jh2, jst2 = jx.mlstm_chunked(*(a[:, 12:] for a in j_ins), chunk=6, state=jst)
    assert_close(h2, jh2, TOL, TOL)
    for i in range(3):
        assert_close(st2[i], jst2[i], TOL, TOL)


def test_mlstm_recurrent_step_matches_jax():
    rng = np.random.default_rng(5)
    b, h, d = 2, 3, 8
    state = (rng.normal(size=(b, h, d, d)).astype(np.float32),
             rng.normal(size=(b, h, d)).astype(np.float32),
             rng.normal(size=(b, h)).astype(np.float32))
    q, k, v = (rng.normal(size=(b, h, d)).astype(np.float32) for _ in range(3))
    log_f = (-np.abs(rng.normal(size=(b, h)))).astype(np.float32)
    log_i = rng.normal(size=(b, h)).astype(np.float32)
    jst, jh = jx.mlstm_recurrent_step(tuple(jnp.asarray(a) for a in state),
                                      *(jnp.asarray(a) for a in (q, k, v, log_f, log_i)))
    st, hh = xlstm.mlstm_recurrent_step(tuple(torch.from_numpy(a) for a in state),
                                        *(torch.from_numpy(a) for a in (q, k, v, log_f, log_i)))
    assert_close(hh, jh, TOL, TOL, "h")
    for i in range(3):
        assert_close(st[i], jst[i], TOL, TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_scan_matches_jax(with_state):
    rng = np.random.default_rng(6)
    b, s, h, d = 2, 14, 2, 4
    gates = rng.normal(size=(b, s, h, 4, d)).astype(np.float32)
    r = (rng.normal(size=(h, 4, d, d)) * 0.2).astype(np.float32)
    state = None
    if with_state:
        state = tuple(rng.normal(size=(b, h, d)).astype(np.float32) for _ in range(4))
        state = (state[0], np.abs(state[1]) + 1, state[2], state[3])
    jh, jst = jx.slstm_scan(jnp.asarray(gates), jnp.asarray(r),
                            None if state is None else tuple(jnp.asarray(a) for a in state))
    hh, st = xlstm.slstm_scan(torch.from_numpy(gates), torch.from_numpy(r),
                              None if state is None else tuple(torch.from_numpy(a)
                                                               for a in state))
    assert_close(hh, jh, 1e-5, 1e-5, "h")
    for i in range(4):
        assert_close(st[i], jst[i], 1e-5, 1e-5)
