"""The port's dense LM serving path against the JAX package on the CPU:
configs, layer order, `params_from_jax`, and prefill + cached decode
(logits, every cache k/v in ring order, `pos`, greedy tokens) on four
reduced dense configs in float32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import dense as jdense
from repro.models.config import reduced as jreduced
from repro_torch.configs import ARCHS, get_arch
from repro_torch.models import dense, model_zoo
from repro_torch.models.config import reduced

from _torch_parity import dense_cache_layers, flatten_tree, to_torch_model

# Logits and caches agree within 1e-4 abs/rel. Measured on a CPU over the
# four configs, prefill and 4 decode steps: at most 4.9e-6 on logits (of
# |logit| up to 4.2) and 6.7e-6 on cache entries.
TOL = 1e-4
BATCH, PROMPT, DECODE = 2, 80, 4

# reduced(): d 128, 4 heads, head dim 32, vocab 512, window ≤ 64. gemma3 at 8
# layers is one 6-layer group (5 window layers + 1 global) plus 2 remainder
# window layers; the 80-token prompt exceeds its 64-slot ring.
DENSE_CASES = {
    "qwen2.5-3b": {},
    "gemma3-4b": dict(n_layers=8),
    "stablelm-1.6b": {},
    "mistral-large-123b": {},
}


def _randomize(tree, rng):
    """Seeded values for the QKV biases and norm scales, which the JAX init
    leaves at zeros and ones."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _randomize(val, rng)
        elif key in ("bq", "bk", "bv"):
            out[key] = jnp.asarray(0.5 * rng.normal(size=val.shape), val.dtype)
        elif key.endswith("norm"):
            out[key] = jnp.asarray(1.0 + 0.2 * rng.normal(size=val.shape), val.dtype)
        else:
            out[key] = val
    return out


def _assert_close(a, b, what):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL, err_msg=what)


def _assert_caches(tcache, jcache, cfg, what):
    assert tcache["pos"] == int(jcache["pos"]), what
    jl = dense_cache_layers(jcache, cfg)
    assert len(jl) == len(tcache["layers"]) == cfg.n_layers
    for i, (t, j) in enumerate(zip(tcache["layers"], jl)):
        for n in ("k", "v"):
            assert tuple(t[n].shape) == j[n].shape, (what, i, n)
            _assert_close(t[n], j[n], f"{what}: layer {i} {n}")


@pytest.mark.parametrize("name", list(DENSE_CASES))
def test_prefill_and_decode_match_jax(name):
    jcfg = jreduced(JAX_ARCHS[name], **DENSE_CASES[name])
    cfg = reduced(get_arch(name), **DENSE_CASES[name])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    params, _ = jdense.init(jax.random.PRNGKey(0), jcfg)
    params = _randomize(params, np.random.default_rng(1))
    model = to_torch_model(params, cfg)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (BATCH, PROMPT))
    max_len = PROMPT + DECODE

    jlog, jcache = jdense.prefill(params, {"tokens": jnp.asarray(tokens, jnp.int32)},
                                  jcfg, max_len=max_len)
    tlog, tcache = dense.prefill(model, {"tokens": torch.from_numpy(tokens)},
                                 max_len=max_len)
    assert tlog.dtype == torch.float32 and tuple(tlog.shape) == (BATCH, cfg.vocab_padded)
    _assert_close(tlog, jlog, "prefill logits")
    _assert_caches(tcache, jcache, cfg, "prefill")

    for step in range(DECODE):
        jtok = jnp.argmax(jlog[:, :cfg.vocab], axis=-1).astype(jnp.int32)
        ttok = torch.argmax(tlog[:, :cfg.vocab], dim=-1)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok), f"step {step}")
        jlog, jcache = jdense.decode_step(params, jcache, {"token": jtok}, jcfg)
        tlog, tcache = dense.decode_step(model, tcache, {"token": ttok})
        _assert_close(tlog, jlog, f"decode {step} logits")
        _assert_caches(tcache, jcache, cfg, f"decode {step}")


def test_dense_params_from_jax_layer_order():
    """gemma3 at 14 layers: layer 6g+si is groups/sub{si} at group g (g < 2),
    layers 12 and 13 are rem0 and rem1; windows follow the same order."""
    name = "gemma3-4b"
    jcfg = jreduced(JAX_ARCHS[name], n_layers=14)
    cfg = reduced(get_arch(name), n_layers=14)
    params, _ = jdense.init(jax.random.PRNGKey(3), jcfg)
    model = to_torch_model(params, cfg)
    want = [("groups", g, si) for g in range(2) for si in range(6)] + [("rem", 0, 0),
                                                                        ("rem", 1, 0)]
    for i, (kind, a, si) in enumerate(want):
        src = (params["groups"][f"sub{si}"]["attn"]["wq"][a] if kind == "groups"
               else params[f"rem{a}"]["attn"]["wq"])
        np.testing.assert_array_equal(model.layers[i].attn.wq.detach().numpy(), np.asarray(src))
    assert dense.layer_windows(cfg) == (64,) * 5 + (0,) + (64,) * 5 + (0,) + (64, 64)
    assert [b.window for b in model.layers] == list(dense.layer_windows(cfg))


def test_dense_params_from_jax_takes_bf16():
    """bf16 arrays reach numpy as ml_dtypes.bfloat16; they cross through
    float32 exactly."""
    jcfg = jreduced(JAX_ARCHS["qwen2.5-3b"], dtype="bfloat16", n_layers=2)
    cfg = reduced(get_arch("qwen2.5-3b"), dtype="bfloat16", n_layers=2)
    params, _ = jdense.init(jax.random.PRNGKey(4), jcfg)
    params = _randomize(params, np.random.default_rng(5))
    model = to_torch_model(params, cfg)
    flat = flatten_tree(params)
    assert model.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(model.embed.detach().float().numpy(),
                                  np.asarray(flat["embed"], np.float32))
    np.testing.assert_array_equal(model.layers[1].attn.bk.detach().float().numpy(),
                                  np.asarray(flat["groups/sub0/attn/bk"][1], np.float32))


@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_configs_and_layer_pattern_match_jax(name):
    from repro.models.dense import layer_pattern as jpattern
    cfg, jcfg = get_arch(name), JAX_ARCHS[name]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.param_count, cfg.active_param_count, cfg.vocab_padded, cfg.hd) == (
        jcfg.param_count, jcfg.active_param_count, jcfg.vocab_padded, jcfg.hd)
    assert dense.layer_pattern(cfg) == jpattern(jcfg)
    assert sorted(ARCHS) == sorted(JAX_ARCHS)


@pytest.mark.parametrize("name", list(DENSE_CASES))
def test_make_cache_matches_jax(name):
    jcfg = jreduced(JAX_ARCHS[name], **DENSE_CASES[name])
    cfg = reduced(get_arch(name), **DENSE_CASES[name])
    jc = jdense.make_cache(jcfg, 3, 50)
    tc = model_zoo.get_model(cfg).make_cache(3, 50, device="cpu")
    _assert_caches(tc, jc, cfg, "make_cache")


def test_model_size_is_the_analytic_count():
    """numel = param_count (projections, MLP, embed, unembed) + the norm
    scales + the QKV biases."""
    cfg = reduced(get_arch("qwen2.5-3b"))
    model = dense.DenseLM(cfg, seed=0, device="cpu")
    extra = (2 * cfg.n_layers + 1) * cfg.d_model + cfg.n_layers * (
        cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count + extra
    again = dense.DenseLM(cfg, seed=0, device="cpu")
    other = dense.DenseLM(cfg, seed=1, device="cpu")
    assert torch.equal(model.layers[0].attn.wq, again.layers[0].attn.wq)
    assert not torch.equal(model.layers[0].attn.wq, other.layers[0].attn.wq)
    std = float(model.layers[0].mlp.w_down.std())
    assert abs(std - cfg.d_ff ** -0.5) < 0.1 * cfg.d_ff ** -0.5


@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_get_model_serves_every_family_on_the_cpu(name):
    """Every config's bundle at `reduced` size: a prefill (with the family's
    stub inputs) and a greedy decode step, finite logits over the padded
    vocabulary, `pos` counting the image tokens where there are some."""
    cfg = reduced(get_arch(name))
    bundle = model_zoo.get_model(cfg)
    model = bundle.init(seed=0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12)))}
    if cfg.family == "vlm":
        batch["img_embed"] = torch.randn((2, cfg.n_img_tokens, model_zoo.VISION_FEAT))
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((2, 12 // cfg.audio_downsample, model_zoo.AUDIO_FEAT))
    n0 = cfg.n_img_tokens + 12
    logits, cache = bundle.prefill(model, batch, max_len=n0 + 1)
    logits2, cache = bundle.decode_step(model, cache,
                                        {"token": logits[:, :cfg.vocab].argmax(-1)})
    assert tuple(logits2.shape) == (2, cfg.vocab_padded) and logits2.dtype == torch.float32
    assert torch.isfinite(logits).all() and torch.isfinite(logits2).all()
    assert cache["pos"] == n0 + 1


def test_get_model_bundle_serves_on_the_cpu():
    cfg = reduced(get_arch("qwen2.5-3b"), n_layers=2)
    bundle = model_zoo.get_model(cfg)
    model = bundle.init(seed=0, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 12)))
    logits, cache = bundle.prefill(model, {"tokens": tok}, max_len=14)
    logits2, cache = bundle.decode_step(model, cache, {"token": logits[:, :cfg.vocab]
                                                       .argmax(-1)})
    assert cache["pos"] == 13 and torch.isfinite(logits2).all()
    assert torch.allclose(dense.forward(model, tok)[:, -1] @ model.unembed, logits,
                          rtol=1e-5, atol=1e-5)
