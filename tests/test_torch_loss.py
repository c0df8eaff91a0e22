"""The port's training loss against the JAX package on the CPU:
`layers.chunked_ce` (the cases of `tests/test_chunked_ce.py`) and the
dense, MoE and vlm families' `loss` and its gradient for every parameter
against `jax.value_and_grad(model.loss)`, in float32 at `reduced` size
(the other families: `tests/test_torch_loss_families.py`).

The port's model holds the JAX tree (`convert.params_from_jax`, the norm
scales and QKV biases seeded), and its gradients go back through
`convert.stack_as_jax`, JAX's keys and stacked groups. Tolerances: the
loss within 1e-5 rtol, each gradient within 1e-4 rtol / 1e-6 atol, as
`tests/test_chunked_ce.py` holds its gradients.

One exception: the embed gradient is held within 1e-5 of its largest
|value| (EMBED_SCALE_TOL). It is a sum, over each token's positions, of
everything the layers send back to the residual stream, so its entries
carry that stream's float32 error, which is set by the stream's scale and
not by the entry's: measured on a CPU, paligemma's entry -0.008405 is
2.8e-6 from JAX's (1.5 times the 1e-4/1e-6 bound, 3.7e-6 of the leaf's
largest |value| 1.13), Zamba2's worst entry 1.02 times the bound (2.2e-6
of its scale).

MoE: the aux term within 1e-6, and every layer routes every token to the
same experts (JAX's routes read by a `jax.debug.callback` in its scan)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import layers as jlayers
from repro.models import model_zoo as jzoo
from repro.models import moe as jmoe
from repro.models.config import reduced as jreduced
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.models import layers, model_zoo, moe
from repro_torch.models.config import reduced

from _torch_parity import (flatten_tree, np_, one_torch_thread,  # noqa: F401 (a fixture)
                           randomize_constants, to_torch_model)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BATCH, SEQ = 2, 32


def _full_ce(x, w, t):
    logits = jnp.einsum("bsd,dv->bsv", x, w).astype(jnp.float32)
    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.take_along_axis(logp, t[..., None], axis=-1)[..., 0].mean()


@pytest.mark.parametrize("b,s,d,v,chunk", [
    (2, 32, 16, 100, 8),
    (1, 64, 8, 257, 16),
    (3, 24, 12, 50, 24),   # chunk == s
    (2, 30, 8, 64, 7),     # indivisible → the full-logits path
])
def test_chunked_ce_matches_jax(b, s, d, v, chunk):
    rng = np.random.default_rng(b * s + v)
    xa = rng.normal(size=(b, s, d)).astype(np.float32)
    wa = rng.normal(size=(d, v)).astype(np.float32)
    ta = rng.integers(0, v, (b, s)).astype(np.int32)
    x, w, t = jnp.asarray(xa), jnp.asarray(wa), jnp.asarray(ta)
    jl, (jgx, jgw) = jax.value_and_grad(
        lambda xx, ww: jlayers.chunked_ce(xx, ww, t, seq_chunk=chunk), argnums=(0, 1))(x, w)
    tx = torch.from_numpy(xa).requires_grad_()
    tw = torch.from_numpy(wa).requires_grad_()
    loss = layers.chunked_ce(tx, tw, torch.from_numpy(ta), seq_chunk=chunk)
    gx, gw = torch.autograd.grad(loss, (tx, tw))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(_full_ce(x, w, t)), rtol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), rtol=1e-4, atol=1e-6)


def test_chunked_ce_bf16_inputs():
    """bfloat16 x and unembed: the logits are the bf16 product cast to
    float32, as in JAX; the loss is float32, finite, and JAX's to 1e-5."""
    rng = np.random.default_rng(0)
    xa = rng.normal(size=(2, 16, 8)).astype(np.float32)
    wa = rng.normal(size=(8, 40)).astype(np.float32)
    ta = rng.integers(0, 40, (2, 16)).astype(np.int32)
    out = layers.chunked_ce(torch.from_numpy(xa).to(torch.bfloat16),
                            torch.from_numpy(wa).to(torch.bfloat16),
                            torch.from_numpy(ta), seq_chunk=4)
    jout = jlayers.chunked_ce(jnp.asarray(xa, jnp.bfloat16), jnp.asarray(wa, jnp.bfloat16),
                              jnp.asarray(ta), seq_chunk=4)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out))
    np.testing.assert_allclose(float(out), float(jout), rtol=1e-5)


# -- every family's loss and gradients ---------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(jcfg):
    """JAX's jitted loss and gradient for one config, compiled once a
    config (cases that differ only in values share it)."""
    return jax.jit(jax.value_and_grad(jzoo.get_model(jcfg).loss))


def _restore_leaves(seeded, init, names):
    """`seeded` with the leaves called one of `names` taken from `init`."""
    return {k: (_restore_leaves(v, init[k], names) if isinstance(v, dict)
                else init[k] if k in names else v) for k, v in seeded.items()}


def family_case(name, over=None, init_leaves=()):
    """(JAX loss, JAX grads flattened, port loss, port grads by JAX key,
    cfg, the port's model, the batch) for one config at reduced size, its
    constant leaves seeded except those named in `init_leaves`."""
    over = over or {}
    jcfg, cfg = jreduced(JAX_ARCHS[name], **over), reduced(get_arch(name), **over)
    jb = jzoo.get_model(jcfg)
    init, _ = jb.init(jax.random.PRNGKey(0))
    params = _restore_leaves(randomize_constants(init, np.random.default_rng(1)), init,
                             init_leaves)
    rng = np.random.default_rng(2)
    arrays = {"tokens": rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32),
              "targets": rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)}
    for key, shape in model_zoo.stub_shapes(cfg, SEQ).items():
        arrays[key] = rng.normal(size=(BATCH,) + shape).astype(np.float32)
    jl, jg = _jax_value_and_grad(jcfg)(params, {k: jnp.asarray(a) for k, a in arrays.items()})
    model = to_torch_model(params, cfg)
    batch = {k: torch.from_numpy(a) for k, a in arrays.items()}
    loss = model_zoo.get_model(cfg).loss(model, batch)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    ours = {k: np_(g) for k, g in convert.stack_as_jax(dict(zip(named, grads)), cfg).items()}
    return dict(jloss=float(jl), jgrads=flatten_tree(jg), loss=float(loss), grads=ours,
                cfg=cfg, jcfg=jcfg, params=params, model=model, batch=batch, arrays=arrays)


EMBED_SCALE_TOL = 1e-5     # the embed gradient, of its largest |value|


def check_family(case, leaf_scale_tol: float = 0.0):
    """The loss within 1e-5 rtol; every parameter's gradient finite,
    non-zero and within 1e-4 rtol / 1e-6 atol of JAX's; the embed gradient
    within EMBED_SCALE_TOL of its largest |value|; with `leaf_scale_tol`,
    every gradient within that fraction of its leaf's largest |value|."""
    np.testing.assert_allclose(case["loss"], case["jloss"], rtol=1e-5)
    assert set(case["grads"]) == set(case["jgrads"])
    for k, g in case["jgrads"].items():
        ours = case["grads"][k]
        assert np.isfinite(ours).all() and np.abs(ours).max() > 0, k
        scale = leaf_scale_tol or (EMBED_SCALE_TOL if k == "embed" else 0.0)
        if scale:
            np.testing.assert_allclose(ours, g, rtol=0, atol=scale * np.abs(g).max(), err_msg=k)
        else:
            np.testing.assert_allclose(ours, g, rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def moe_case():
    return family_case("granite-moe-1b-a400m")


@pytest.mark.parametrize("name", ["qwen2.5-3b", "paligemma-3b"])
def test_dense_and_vlm_loss_and_grads_match_jax(name):
    check_family(family_case(name))


# gemma3-4b as the train step's K7 sees it: head dim 320 (K7's widest
# bucket), 7 layers (one group of 5 local + 1 global and a local
# remainder), the window cut to 16 so that it bites at SEQ 32
GEMMA3_320 = dict(n_layers=7, head_dim=320, sliding_window=16)


@pytest.fixture(scope="module")
def gemma3_case():
    return family_case("gemma3-4b", GEMMA3_320)


def test_gemma3_head_dim_320_loss_and_grads_match_jax(gemma3_case):
    """gemma3-4b's loss and every gradient at head dim 320 with its 5:1
    local/global pattern (local layers windowed), against JAX's: the path
    of the full-width train step, through K7's plain versions here."""
    cfg = gemma3_case["cfg"]
    assert cfg.hd == 320 and cfg.sliding_window == 16 < SEQ
    check_family(gemma3_case)


def test_moe_loss_and_grads_match_jax(moe_case):
    check_family(moe_case)


def test_moe_aux_and_routes_match_jax(moe_case, monkeypatch):
    """The layers' mean aux within 1e-6, and every layer's top-k experts
    of every token equal JAX's."""
    cfg, jcfg, model = moe_case["cfg"], moe_case["jcfg"], moe_case["model"]
    routes, jroutes = [], []
    real_route, real_top_k = moe.route, jax.lax.top_k

    def route(x, p, k):
        r = real_route(x, p, k)
        routes.append(r[2])
        return r

    def top_k(x, k):        # traced into JAX's layer scan: a callback per layer
        r = real_top_k(x, k)
        jax.debug.callback(lambda e: jroutes.append(np.asarray(e)), r[1])
        return r

    monkeypatch.setattr(moe, "route", route)
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    tokens = moe_case["arrays"]["tokens"]
    with torch.no_grad():
        _x, aux = moe.forward(model, torch.from_numpy(tokens))
    _jx, jaux = jmoe.forward(moe_case["params"], jnp.asarray(tokens), jcfg)
    jax.effects_barrier()
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)
    assert len(routes) == len(jroutes) == cfg.n_layers
    for ours, theirs in zip(routes, jroutes):
        np.testing.assert_array_equal(ours.numpy(), theirs.reshape(ours.shape))


def test_remat_changes_neither_loss_nor_grads():
    """`cfg.remat` (off in `reduced`) recomputes each unit in the backward:
    on the dense family with a remainder layer (gemma3's 5:1 pattern at 7
    layers: one group and one remainder), the loss and every gradient are
    the same as without it, bit for bit."""
    out = []
    for remat in (False, True):
        cfg = reduced(get_arch("gemma3-4b"), n_layers=7, remat=remat)
        model = model_zoo.get_model(cfg).init(seed=3, device="cpu")
        rng = np.random.default_rng(4)
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32))),
                 "targets": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)))}
        loss = model_zoo.get_model(cfg).loss(model, batch)
        out.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_k7_autograd_function_backward_is_the_plain_gradient(monkeypatch):
    """K7's autograd Function with the plain version in the kernel's place
    (no card here): on the strided (B, H, L, D) views `models.attention`
    hands K7, its forward launches once and its backward none, and the q,
    k and v gradients equal those of the plain version, bit for bit."""
    from repro_torch.kernels import flash_attention as FA
    launched = []

    def launch(q, k, v, causal, window):
        launched.append(1)
        return FA.flash_attention_plain(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(FA, "_launch", launch)
    rng = np.random.default_rng(5)
    base = [torch.from_numpy(rng.normal(size=(2, 40, n, 16)).astype(np.float32))
            for n in (4, 2, 2)]
    w = torch.from_numpy(rng.normal(size=(2, 4, 40, 16)).astype(np.float32))
    grads = []
    for use_fn in (True, False):
        leaves = [t.clone().requires_grad_() for t in base]
        views = [t.transpose(1, 2) for t in leaves]
        out = (FA.FlashAttentionFn.apply(*views, True, 24) if use_fn
               else FA.flash_attention_plain(*views, causal=True, window=24))
        (out * w).sum().backward()
        grads.append([t.grad for t in leaves])
    assert len(launched) == 1
    for a, b in zip(*grads):
        assert torch.equal(a, b) and a.abs().max() > 0
