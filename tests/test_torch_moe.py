"""The port's MoE family against the JAX package on the CPU, in float32:
`moe_mlp` and `moe_mlp_reference` against JAX's at capacity factor 8 (no
drops) and 1.0 (drops), the routing order on tied probabilities, and
both MoE configs' prefill (logits and every cache leaf) and 3 decode
steps at `reduced` size, with weights carried by `convert.params_from_jax`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import moe as jmoe
from repro.models import model_zoo as jzoo
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import reduced as jreduced
from repro_torch.configs import get_arch
from repro_torch.models import model_zoo, moe
from repro_torch.models.config import ModelConfig, reduced

from _torch_parity import (assert_cache_close, assert_close, np_, port_cache_from_jax,
                           randomize_constants, to_torch_model)

TOL = 1e-4      # as tests/test_torch_dense.py
AUX_TOL = 1e-6

# the layer configs of tests/test_ssm.py's MoE tests: capacity factor 8 (no
# drops) and capacity factor 1.0 with 4 experts (drops)
MLP_CASES = {
    "cf8": (dict(n_experts=8, top_k=2, capacity_factor=8.0), 0, (2, 16, 32), 0),
    "cf1": (dict(n_experts=4, top_k=2, capacity_factor=1.0), 1, (4, 32, 32), 1),
}


def _layer(case):
    """The JAX layer params, the port's `MoEMLP` holding them, the config
    (JAX's and the port's) and the input x."""
    over, key, shape, seed = MLP_CASES[case]
    kw = dict(name="m", family="moe", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
              d_ff=48, vocab=100, head_dim=16, dtype="float32", remat=False, **over)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    params, _ = jmoe.init(jax.random.PRNGKey(key), jcfg)
    lp = jax.tree.map(lambda a: a[0], params["layers"])
    mlp = moe.MoEMLP(cfg, torch.float32, "cpu", torch.Generator().manual_seed(0))
    mlp.load_state_dict({n: torch.from_numpy(np.array(lp[n])) for n in
                         ("router", "w_gate", "w_up", "w_down")})
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return lp, mlp, jcfg, cfg, x


@pytest.mark.parametrize("case", list(MLP_CASES))
def test_moe_mlp_matches_jax(case):
    lp, mlp, jcfg, cfg, x = _layer(case)
    jout, jaux = jmoe.moe_mlp(jnp.asarray(x), lp, jcfg)
    out, aux = moe.moe_mlp(torch.from_numpy(x), mlp, cfg)
    assert_close(out, jout, TOL, TOL, "moe_mlp")
    assert abs(float(aux) - float(jaux)) <= AUX_TOL, (float(aux), float(jaux))
    ref = moe.moe_mlp_reference(torch.from_numpy(x), mlp, cfg)
    jref = jmoe.moe_mlp_reference(jnp.asarray(x), lp, jcfg)
    assert_close(ref, jref, TOL, TOL, "moe_mlp_reference")

    n = x.shape[0] * x.shape[1]
    _p, _w, top_e = moe.route(torch.from_numpy(x).reshape(n, -1), mlp.router, cfg.top_k)
    cap = moe.capacity(n, cfg)
    slot, _tok = moe.dispatch(top_e, cap, cfg.n_experts)
    dropped = int((slot == cfg.n_experts * cap).sum())
    # a dropped assignment moves its row by a whole expert's share: rows
    # with a drop differ from the no-capacity oracle, the others do not
    rows_dropped = (slot.view(n, -1) == cfg.n_experts * cap).any(-1).numpy()
    moved = np.abs(np_(jout) - np_(jref)).reshape(n, -1).max(-1) > 1e-3
    np.testing.assert_array_equal(moved, rows_dropped)
    if case == "cf8":
        assert dropped == 0
        assert_close(out, ref, 1e-5, 1e-5, "no drops: moe_mlp equals the oracle")
    else:
        assert dropped > 0 and rows_dropped.sum() > 0, dropped


def test_moe_tie_order_is_lax_top_k():
    """Duplicated router columns give tied probabilities (exactly: every
    product and sum is a small dyadic rational); the port keeps the lower
    expert first, as `lax.top_k` does, and routes as JAX does."""
    _lp, mlp, _jcfg, cfg, _x = _layer("cf8")
    rng = np.random.default_rng(4)
    router = rng.integers(-4, 5, (32, 8)).astype(np.float32) / 8
    router[:, 5], router[:, 6] = router[:, 1], router[:, 2]
    router[:, 7] = router[:, 1]
    x = rng.integers(-2, 3, (2, 16, 32)).astype(np.float32) / 2
    with torch.no_grad():
        mlp.router.copy_(torch.from_numpy(router))
    lp = {"router": jnp.asarray(router), "w_gate": jnp.asarray(np_(mlp.w_gate)),
          "w_up": jnp.asarray(np_(mlp.w_up)), "w_down": jnp.asarray(np_(mlp.w_down))}
    jcfg = JModelConfig(**dataclasses.asdict(cfg))

    xf = torch.from_numpy(x).reshape(32, 32)
    probs, _w, top_e = moe.route(xf, mlp.router, 3)
    jw, je = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x).reshape(32, 32) @ router, -1), 3)
    p = np_(probs)
    assert (p[:, 5] == p[:, 1]).all() and (p[:, 7] == p[:, 1]).all()
    ps = -np.sort(-p, axis=-1)
    ties = (ps[:, 1:3] == ps[:, :2]).any(-1) | (ps[:, 2] == ps[:, 3])
    assert ties.sum() >= 4, "too few ties among the top k"
    np.testing.assert_array_equal(np_(top_e), np.asarray(je))
    out, _aux = moe.moe_mlp(torch.from_numpy(x), mlp, cfg)
    jout, _jaux = jmoe.moe_mlp(jnp.asarray(x), lp, jcfg)
    assert_close(out, jout, TOL, TOL, "moe_mlp on tied routes")


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "qwen3-moe-235b-a22b"])
def test_moe_prefill_and_decode_match_jax(name):
    jcfg, cfg = jreduced(JAX_ARCHS[name]), reduced(get_arch(name))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jb, tb = jzoo.get_model(jcfg), model_zoo.get_model(cfg)
    params, _ = jb.init(jax.random.PRNGKey(0))
    params = randomize_constants(params, np.random.default_rng(1))
    model = to_torch_model(params, cfg)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 40))
    max_len = 40 + 3
    jl, jc = jb.prefill(params, {"tokens": jnp.asarray(tokens, jnp.int32)}, max_len=max_len)
    tl, tc = tb.prefill(model, {"tokens": torch.from_numpy(tokens)}, max_len=max_len)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, cfg.vocab_padded)
    assert_close(tl, jl, TOL, TOL, "prefill logits")
    assert_cache_close(tc, port_cache_from_jax(jc, cfg), TOL, TOL, "prefill cache")
    for step in range(3):
        tok = np.asarray(jnp.argmax(jl[:, :cfg.vocab], -1)).astype(np.int64)
        np.testing.assert_array_equal(np_(tl[:, :cfg.vocab].argmax(-1)), tok)
        jl, jc = jb.decode_step(params, jc, {"token": jnp.asarray(tok, jnp.int32)})
        tl, tc = tb.decode_step(model, tc, {"token": torch.from_numpy(tok)})
        assert_close(tl, jl, TOL, TOL, f"decode {step} logits")
        assert_cache_close(tc, port_cache_from_jax(jc, cfg), TOL, TOL, f"decode {step} cache")


def test_moe_forward_aux_matches_jax():
    name = "granite-moe-1b-a400m"
    jcfg, cfg = jreduced(JAX_ARCHS[name], n_layers=2), reduced(get_arch(name), n_layers=2)
    params, _ = jmoe.init(jax.random.PRNGKey(5), jcfg)
    model = to_torch_model(params, cfg)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (2, 24))
    jx, jaux = jmoe.forward(params, jnp.asarray(tokens, jnp.int32), jcfg)
    x, aux = moe.forward(model, torch.from_numpy(tokens))
    assert_close(x, jx, TOL, TOL, "hidden states")
    assert abs(float(aux) - float(jaux)) <= AUX_TOL
